"""Distributed chordal initialization (DChordal) — four Nesterov-accelerated
Jacobi-MM linear stages, on the device.

Reproduces the reference pipeline driven by dist_pgo.cpp:144-415 using the
C++/DChordal classes (DChordalReduced_{R,t}, DChordal_{R,t}):

  stage 0  per-node solve of the intra-edge subgraph (chordal init + TNT
           refinement; the reference runs per-node SE-Sync)
  stage 1  reduced rotation: one d x d unknown per NODE aligning the local
           solutions, cost kappa |S_a nR_e - S_b|^2 with
           nR_e = R_tail^loc R~ (R_head^loc)^T   (DChordal_utils.cpp:67-310)
  stage 2  full per-pose rotation: linear least squares in ambient d x d
           blocks, per-node exact solves (DChordal_utils.cpp:605-914)
  stage 3  reduced translation: one offset per node
           (DChordal_utils.cpp:365-604)
  stage 4  full per-pose translation (DChordal_utils.cpp:915-1205)

Every stage is the same pattern as the main MM solver restricted to a linear
block: per-node quadratic G = (intra part) + 2 x (inter self part) + xi, and
an exact per-node solve of G x = -g(Y) at the Nesterov-extrapolated point
Y = (1 + gamma) X_k - gamma X_{k-1} (DChordal.cpp:79-128). All nodes update
simultaneously (Jacobi); the 2x inter majorization guarantees descent.

Deviations from the reference (documented): instead of pinning node 0 (or its
first pose) as a gauge anchor, the near-null gauge modes are handled by the
same eigendecomposition-split inverse used for the translation solves — the
result differs only by a global gauge transform, which PGO costs are
invariant to.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from dpgo_tpu.graph import MultiGraph, build_multigraph
from dpgo_tpu.io.g2o import Measurements
from dpgo_tpu.manifold import project_sod, proj_tangent
from dpgo_tpu.problem import NodeProblem, NodeState, build_node_problems
from dpgo_tpu.solvers.tnt import TNTParams, tnt
from dpgo_tpu.solvers.mm import _make_tnt_model


@dataclasses.dataclass(frozen=True)
class DChordalConfig:
    """Stage iteration counts follow the reference driver
    (dist_pgo.cpp:205,271,345,393)."""

    iters_reduced_R: int = 100
    iters_full_R: int = 400
    iters_reduced_t: int = 150
    iters_full_t: int = 250
    reg: float = 1e-12
    refine_stage0: bool = True
    stage0_tnt_iters: int = 20


def chordal_objective(meas: Measurements, t, R) -> float:
    """Objective monitor for the chordal pipeline (the reference's
    DChordal evaluate_f, DChordal_utils.h:129-140 — logging only): the PGO
    cost evaluated at the current (possibly non-SO(d)) iterate, which is
    exactly the linear least-squares cost the chordal stages minimize."""
    from dpgo_tpu.objective import EdgeData, evaluate_f
    edges = EdgeData.from_measurements(meas, dtype=jnp.asarray(t).dtype)
    return float(evaluate_f(edges, jnp.asarray(t), jnp.asarray(R)))


def _intra_only_multigraph(mg: MultiGraph) -> MultiGraph:
    mg2 = dataclasses.replace(mg)
    mg2.e_kap = np.zeros_like(mg.e_kap)
    mg2.e_tau = np.zeros_like(mg.e_tau)
    return mg2


def _nesterov_scan(step_fn, X0, num_iters):
    """Run X_{k+1} = step_fn(Y_k) with Y = (1+gamma) X_k - gamma X_{k-1}."""

    def body(k, carry):
        X, X_prev, s = carry
        s1 = 0.5 + 0.5 * jnp.sqrt(4.0 * s * s + 1.0)
        gamma = (s - 1.0) / s1
        Y = jax.tree.map(lambda a, b: (1.0 + gamma) * a - gamma * b,
                         X, X_prev)
        X_new = step_fn(Y)
        return X_new, X, s1

    X, _, _ = lax.fori_loop(0, num_iters, body,
                            (X0, X0, jnp.ones((), X0.dtype)))
    return X


def _split_inverse(mats: np.ndarray, reg: float):
    """Eigen-split inverse of a stack of PSD matrices + reg I (same treatment
    as the translation solver in problem.py)."""
    lam, V = np.linalg.eigh(mats)
    lam = np.maximum(lam, 0.0)
    scale = np.maximum(lam.max(axis=1, keepdims=True), 1.0)
    null = lam < 1e-10 * scale
    kmax = max(int(null.sum(axis=1).max()), 1)
    N, n = mats.shape[0], mats.shape[1]
    red = np.zeros_like(mats)
    nullV = np.zeros((N, n, kmax))
    for a in range(N):
        w = np.where(null[a], 0.0, 1.0 / (lam[a] + reg))
        red[a] = (V[a] * w[None, :]) @ V[a].T
        k = int(null[a].sum())
        nullV[a][:, :k] = V[a][:, null[a]]
    return red, nullV


def _apply_split(red, nullV, reg, rhs):
    out = jnp.einsum("pq,qa->pa", red, rhs)
    c = jnp.einsum("pk,pa->ka", nullV, rhs) / reg
    return out + jnp.einsum("pk,ka->pa", nullV, c)


def distributed_chordal_init(meas: Measurements, num_nodes: int,
                             cfg: DChordalConfig = DChordalConfig(),
                             dtype=jnp.float64):
    """Run the 4-stage pipeline; returns global (t [P, d], R [P, d, d])."""
    from dpgo_tpu.sesync.init import chordal_initialization
    from dpgo_tpu.graph import partition_measurements

    part, nodes, mg = build_multigraph(meas, num_nodes)
    d, N, n0m = mg.d, mg.num_nodes, mg.n0_max
    xi = cfg.reg

    probs = build_node_problems(mg, xi=max(xi, 1e-12), dtype=dtype)
    mg0 = _intra_only_multigraph(mg)
    probs0 = build_node_problems(mg0, xi=max(xi, 1e-12), dtype=dtype)

    halo_owner = jnp.asarray(mg.halo_owner)
    halo_lpose = jnp.asarray(mg.halo_lpose)

    def exchange(arr):
        return arr[halo_owner, halo_lpose]

    # ---------------- stage 0: per-node local solutions -------------------
    R_loc = np.tile(np.eye(d), (N, n0m, 1, 1))
    for a, g in enumerate(nodes):
        if len(g.intra) == 0:
            continue
        sub = Measurements(
            i=g.intra.i, j=g.intra.j, R=g.intra.R, t=g.intra.t,
            kappa=g.intra.kappa, tau=g.intra.tau, num_poses=g.n0, d=d)
        try:
            R_loc[a, :g.n0] = chordal_initialization(sub)
        except Exception:
            pass  # disconnected intra graph: identity seed
    R_loc = jnp.asarray(R_loc, dtype)
    zeros_t = jnp.zeros((N, n0m, d), dtype)
    # Pure-coupling rhs (g = 0): anchor the null response at zero.
    t_loc = jax.vmap(lambda p, R: p.recover_translations(
        R, jnp.zeros((n0m, d), dtype),
        t_anchor=jnp.zeros((n0m, d), dtype)))(probs0, R_loc)

    if cfg.refine_stage0:
        # Per-node Riemannian refinement of the intra-only problem (the
        # reference runs full SE-Sync per node, dist_pgo.cpp:150-158).
        params = TNTParams(max_iterations=cfg.stage0_tnt_iters,
                           max_iterations_accepted=cfg.stage0_tnt_iters)

        def refine(p0, t0, R0):
            Z = NodeState(t=t0, R=R0, th=zeros_t[0, :mg.n1_max][:mg.n1_max],
                          Rh=jnp.tile(jnp.eye(d, dtype=dtype),
                                      (mg.n1_max, 1, 1)))
            g, f = p0.surrogate_g_f(Z)
            # Intra-only problems are all null-space (no inter edges):
            # anchor the translation solves at t0 (see solve_mG00).
            model = _make_tnt_model(p0, g[0], g[1], f, t_anchor=t0)
            tn, Rn, _, _, _ = tnt(model, t0, R0, params)
            return tn, Rn

        t_loc, R_loc = jax.jit(jax.vmap(refine))(probs0, t_loc, R_loc)

    # ---------------- stage 1: reduced rotation ---------------------------
    Rh = exchange(R_loc)
    # per-edge alignment: nR = R_tail R~ R_head^T (tail/head may be halo).
    e_self = jnp.asarray(mg.e_self)
    e_slot = jnp.asarray(mg.e_slot)
    sel = jnp.asarray(mg.e_self_is_i)
    eR = jnp.asarray(mg.e_R, dtype)
    ekap = jnp.asarray(mg.e_kap, dtype)
    etau = jnp.asarray(mg.e_tau, dtype)

    R_self = jnp.take_along_axis(
        R_loc, e_self[:, :, None, None], axis=1)
    R_other = jnp.take_along_axis(Rh, e_slot[:, :, None, None], axis=1)
    R_tail = jnp.where(sel[:, :, None, None], R_self, R_other)
    R_head = jnp.where(sel[:, :, None, None], R_other, R_self)
    nR = jnp.einsum("neab,nebc,nedc->nead", R_tail, eR, R_head)

    nb_node = jnp.asarray(mg.halo_owner)[  # neighbor node of each inter edge
        jnp.arange(N)[:, None], mg.e_slot]
    sum_kap = jnp.sum(ekap, axis=1)  # [N]
    denomR = 2.0 * sum_kap + xi

    def stage1_step(S):
        S_nb = S[nb_node]  # [N, m1, d, d]
        T_tail = jnp.einsum("neab,necb->neac", S_nb, nR)   # S_b nR^T
        T_head = jnp.einsum("neab,nebc->neac", S_nb, nR)   # S_b nR
        T = jnp.where(sel[:, :, None, None], T_tail, T_head)
        pull = jnp.einsum("ne,neab->nab", ekap, T)
        num = (sum_kap + xi)[:, None, None] * S + pull
        # padded-edge kappa = 0 contributes nothing; denom >= xi > 0
        return num / denomR[:, None, None]

    S0 = jnp.tile(jnp.eye(d, dtype=dtype), (N, 1, 1))
    S = _nesterov_scan(jax.jit(stage1_step), S0, cfg.iters_reduced_R)
    S = project_sod(S)
    R1 = jnp.einsum("nab,npbc->npac", S, R_loc)

    # ---------------- stage 2: full rotation ------------------------------
    # Q-storage tall systems: columns decouple; per-node dense split inverse.
    GR = np.zeros((N, n0m * d, n0m * d))
    eye = np.eye(d)
    for a in range(N):
        ii, jj = mg.a_i[a], mg.a_j[a]
        kap = mg.a_kap[a] * mg.a_mask[a]
        Rm = mg.a_R[a]
        for e in range(mg.m0_max):
            if kap[e] == 0:
                continue
            i, j = int(ii[e]), int(jj[e])
            GR[a, i * d:(i + 1) * d, i * d:(i + 1) * d] += kap[e] * eye
            GR[a, j * d:(j + 1) * d, j * d:(j + 1) * d] += kap[e] * eye
            GR[a, i * d:(i + 1) * d, j * d:(j + 1) * d] += -kap[e] * Rm[e]
            GR[a, j * d:(j + 1) * d, i * d:(i + 1) * d] += -kap[e] * Rm[e].T
        es = mg.e_self[a]
        ek = mg.e_kap[a] * mg.e_mask[a]
        for e in range(mg.m1_max):
            if ek[e] == 0:
                continue
            i = int(es[e])
            GR[a, i * d:(i + 1) * d, i * d:(i + 1) * d] += 2 * ek[e] * eye
    GR_red, GR_null = _split_inverse(GR, xi)
    GR_red = jnp.asarray(GR_red, dtype)
    GR_null = jnp.asarray(GR_null, dtype)

    def rot_g(p: NodeProblem, Z: NodeState):
        """Rotation-only surrogate linear term (inter edges; Q-storage)."""
        (u_s, E_s), (u_o, E_o) = p.inter_halves(
            NodeState(t=jnp.zeros_like(Z.t), R=Z.R,
                      th=jnp.zeros_like(Z.th), Rh=Z.Rh))
        # Only the rotation components of the halves matter (t set to 0
        # kills the translation rows; E-halves are rotation-only already).
        g_t, g_R = p.apply_A_self_T(jnp.zeros_like(u_s), E_o - E_s)
        return g_R - p.xi * Z.R

    # Nodes without inter edges are uncoupled BCD blocks: their exact
    # solution is the stage-0 local solve, so stage 2/BCD must leave them
    # untouched (a 1-node run is the extreme case).
    has_inter = sum_kap > 0

    def stage2_step(Rcur):
        Rhh = exchange(Rcur)

        def per_node(p, red, nullV, R_own, R_halo, R_keep, coupled):
            Z = NodeState(t=jnp.zeros((n0m, d), dtype), R=R_own,
                          th=jnp.zeros((mg.n1_max, d), dtype), Rh=R_halo)
            gR = rot_g(p, Z)
            # Solve G_R Q = -g in Q (transposed) tall storage.
            gQ = jnp.swapaxes(gR, -1, -2).reshape(n0m * d, d)
            Q = -_apply_split(red, nullV, xi, gQ)
            Rn = jnp.swapaxes(Q.reshape(n0m, d, d), -1, -2)
            # The rotation stage is homogeneous: a node with no inter-edge
            # pulls iterates a pure contraction whose magnitude decays
            # (the reference avoids this by pinning node 0's first pose).
            # Scale is irrelevant to the final per-block projection, so
            # renormalize only when the iterate shrinks — an exact no-op
            # for inter-coupled nodes, and the degenerate case converges in
            # direction to the spectral (minimal-eigenvector) solution.
            target = jnp.sqrt(jnp.asarray(n0m * d, dtype))
            nrm = jnp.sqrt(jnp.sum(Rn * Rn))
            scale = jnp.minimum(
                jnp.where(nrm < 0.5 * target,
                          target / jnp.maximum(nrm, 1e-300), 1.0), 1e15)
            return jnp.where(coupled, Rn * scale, R_keep)

        return jax.vmap(per_node)(probs, GR_red, GR_null, Rcur, Rhh, R1,
                                  has_inter)

    R2 = _nesterov_scan(jax.jit(stage2_step), R1, cfg.iters_full_R)
    R2 = project_sod(R2)

    # ---------------- stage 3: reduced translation ------------------------
    t_loc2 = jax.vmap(lambda p, R: p.recover_translations(
        R, jnp.zeros((n0m, d), dtype),
        t_anchor=jnp.zeros((n0m, d), dtype)))(probs0, R2)
    th2 = exchange(t_loc2)
    Rh2 = exchange(R2)
    t_self = jnp.take_along_axis(t_loc2, e_self[:, :, None], axis=1)
    t_other = jnp.take_along_axis(th2, e_slot[:, :, None], axis=1)
    R_self2 = jnp.take_along_axis(R2, e_self[:, :, None, None], axis=1)
    R_other2 = jnp.take_along_axis(Rh2, e_slot[:, :, None, None], axis=1)
    t_tail = jnp.where(sel[:, :, None], t_self, t_other)
    t_head = jnp.where(sel[:, :, None], t_other, t_self)
    R_tail2 = jnp.where(sel[:, :, None, None], R_self2, R_other2)
    et = jnp.asarray(mg.e_t, dtype)
    w = t_tail + jnp.einsum("neab,neb->nea", R_tail2, et) - t_head
    sum_tau = jnp.sum(etau, axis=1)
    denomT = 2.0 * sum_tau + xi

    def stage3_step(u):
        u_nb = u[nb_node]  # [N, m1, d]
        pull = jnp.where(sel[:, :, None], u_nb - w, u_nb + w)
        num = (sum_tau + xi)[:, None] * u + jnp.einsum(
            "ne,nea->na", etau, pull)
        return num / denomT[:, None]

    u = _nesterov_scan(jax.jit(stage3_step), jnp.zeros((N, d), dtype),
                       cfg.iters_reduced_t)
    t3 = t_loc2 + u[:, None, :]

    # ---------------- stage 4: full translation ---------------------------
    def trans_g(p: NodeProblem, Z: NodeState):
        """Translation-only surrogate linear term with rotations frozen.

        The t-only residual operator is A_s^t: t -> +/- sqrt(tau) t_self;
        the measurement offset R_tail t~ is a *constant* here (unlike in the
        joint problem where it couples to the rotation variable), so
        g = A_s^t^T (r - 2 A_s^t z_t) - xi z_t with r the full residual.
        """
        ts = Z.t[p.e_self]
        to = Z.th[p.e_slot]
        Rs = Z.R[p.e_self]
        Ro = Z.Rh[p.e_slot]
        selm = p.e_self_is_i[:, None]
        t_tail = jnp.where(selm, ts, to)
        t_head = jnp.where(selm, to, ts)
        R_tail = jnp.where(p.e_self_is_i[:, None, None], Rs, Ro)
        rr = t_tail + jnp.einsum("eab,eb->ea", R_tail, p.e_t) - t_head
        # tail: g_self += tau (rr - 2 t_self); head: g_self += -tau rr
        #                                           - 2 tau t_self
        contrib = jnp.where(selm,
                            p.e_tau[:, None] * (rr - 2.0 * ts),
                            -p.e_tau[:, None] * rr - 2.0
                            * p.e_tau[:, None] * ts)
        g_t = jnp.zeros((n0m, d), dtype).at[p.e_self].add(contrib)
        # intra constant offsets: b_i += tau c_e, b_j -= tau c_e.
        c = jnp.einsum("eab,eb->ea", Z.R[p.a_i], p.a_t)
        b = jnp.zeros((n0m, d), dtype)
        b = b.at[p.a_i].add(p.a_tau[:, None] * c)
        b = b.at[p.a_j].add(-p.a_tau[:, None] * c)
        return g_t + b - p.xi * Z.t

    def stage4_step(tcur):
        thh = exchange(tcur)

        def per_node(p, t_own, t_halo, R_own, R_halo):
            Z = NodeState(t=t_own, R=R_own, th=t_halo, Rh=R_halo)
            g = trans_g(p, Z)
            # g carries -xi Z.t: anchor the null response at Z.t.
            return -p.solve_mG00(g, t_anchor=t_own)

        return jax.vmap(per_node)(probs, tcur, thh, R2, Rh2)

    t4 = _nesterov_scan(jax.jit(stage4_step), t3, cfg.iters_full_t)

    # ---------------- assemble global -------------------------------------
    node_of = jnp.asarray(part.node_of)
    local_of = jnp.asarray(part.local_of)
    t_glob = np.asarray(t4[node_of, local_of])
    R_glob = np.asarray(R2[node_of, local_of])
    return t_glob, R_glob
