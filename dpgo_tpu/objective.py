"""Global matrix-free PGO objective / gradient oracle.

Equivalent of the reference master oracle DPGOStar::evaluate_f /
evaluate_grad (C++/DPGO/src/DPGOStar.cpp:713-829): the exact global objective
and Riemannian gradient on the full (gathered) pose state, used as the metrics
harness of the driver (dist_pgo.cpp:523-527 prints 2*fobj and 2*|grad|).

Every sparse matvec of the reference becomes gather -> batched einsum ->
segment_sum. Works on any backend; dtype follows the inputs.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_tpu.io.g2o import Measurements
from dpgo_tpu.losses import Loss, loss_value, loss_weight
from dpgo_tpu.manifold import proj_tangent


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EdgeData:
    """Device-side flat edge arrays over the global pose index space."""

    i: jnp.ndarray      # [m] int32
    j: jnp.ndarray      # [m] int32
    R: jnp.ndarray      # [m, d, d]
    t: jnp.ndarray      # [m, d]
    kappa: jnp.ndarray  # [m]
    tau: jnp.ndarray    # [m]
    is_inter: jnp.ndarray  # [m] bool: robust loss applies only to these

    @staticmethod
    def from_measurements(meas: Measurements, node_of: np.ndarray | None = None,
                          dtype=jnp.float64) -> "EdgeData":
        if node_of is None:
            is_inter = np.zeros(len(meas), dtype=bool)
        else:
            is_inter = node_of[meas.i] != node_of[meas.j]
        return EdgeData(
            i=jnp.asarray(meas.i, jnp.int32),
            j=jnp.asarray(meas.j, jnp.int32),
            R=jnp.asarray(meas.R, dtype),
            t=jnp.asarray(meas.t, dtype),
            kappa=jnp.asarray(meas.kappa, dtype),
            tau=jnp.asarray(meas.tau, dtype),
            is_inter=jnp.asarray(is_inter),
        )


def edge_residuals(edges: EdgeData, t: jnp.ndarray, R: jnp.ndarray):
    """Per-edge residuals: r_t [m, d] and r_R [m, d, d] (sqrt-weighted)."""
    Ri = R[edges.i]
    rt = t[edges.i] + jnp.einsum("eab,eb->ea", Ri, edges.t) - t[edges.j]
    rR = jnp.einsum("eab,ebc->eac", Ri, edges.R) - R[edges.j]
    sqrt_tau = jnp.sqrt(edges.tau)[:, None]
    sqrt_kap = jnp.sqrt(edges.kappa)[:, None, None]
    return sqrt_tau * rt, sqrt_kap * rR


def edge_sqnorms(edges: EdgeData, t: jnp.ndarray, R: jnp.ndarray):
    rt, rR = edge_residuals(edges, t, R)
    return jnp.sum(rt * rt, axis=-1) + jnp.sum(rR * rR, axis=(-1, -2))


def evaluate_f(edges: EdgeData, t: jnp.ndarray, R: jnp.ndarray,
               loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0) -> jnp.ndarray:
    """Global objective F = 1/2 sum_intra |r|^2 + 1/2 sum_inter rho(|r|^2)."""
    s = edge_sqnorms(edges, t, R)
    if loss == Loss.TRIVIAL:
        return 0.5 * jnp.sum(s)
    vals = jnp.where(edges.is_inter, loss_value(loss, s, loss_reg), s)
    return 0.5 * jnp.sum(vals)


def evaluate_euclidean_grad(edges: EdgeData, t: jnp.ndarray, R: jnp.ndarray,
                            loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0):
    """Euclidean gradient (Df_t [P, d], Df_R [P, d, d]) of evaluate_f."""
    num_poses = t.shape[0]
    rt, rR = edge_residuals(edges, t, R)
    if loss == Loss.TRIVIAL:
        w = jnp.ones_like(edges.tau)
    else:
        s = jnp.sum(rt * rt, axis=-1) + jnp.sum(rR * rR, axis=(-1, -2))
        w = jnp.where(edges.is_inter, loss_weight(loss, s, loss_reg),
                      jnp.ones_like(s))
    # u = w * sqrt(tau) * r_t ; E = w * sqrt(kappa) * r_R  (un-sqrt once more)
    u = (w * jnp.sqrt(edges.tau))[:, None] * rt
    E = (w * jnp.sqrt(edges.kappa))[:, None, None] * rR
    # d/dt_i += u ; d/dt_j -= u
    Df_t = jnp.zeros_like(t)
    Df_t = Df_t.at[edges.i].add(u)
    Df_t = Df_t.at[edges.j].add(-u)
    # d/dR_i += u t~^T + E R~^T ; d/dR_j -= E
    Gi = u[:, :, None] * edges.t[:, None, :] + jnp.einsum(
        "eab,ecb->eac", E, edges.R)
    Df_R = jnp.zeros_like(R)
    Df_R = Df_R.at[edges.i].add(Gi)
    Df_R = Df_R.at[edges.j].add(-E)
    return Df_t, Df_R


def evaluate_riemannian_grad(edges: EdgeData, t: jnp.ndarray, R: jnp.ndarray,
                             loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0):
    """Riemannian gradient: translation part unchanged, rotation part
    projected onto the tangent space of SO(d)^n (DPGOStar.cpp:821-827)."""
    Df_t, Df_R = evaluate_euclidean_grad(edges, t, R, loss, loss_reg)
    return Df_t, proj_tangent(R, Df_R)


def grad_norm(edges: EdgeData, t: jnp.ndarray, R: jnp.ndarray,
              loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0) -> jnp.ndarray:
    g_t, g_R = evaluate_riemannian_grad(edges, t, R, loss, loss_reg)
    return jnp.sqrt(jnp.sum(g_t * g_t) + jnp.sum(g_R * g_R))
