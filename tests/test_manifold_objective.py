"""Tests for manifold ops and the global objective oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu import manifold
from dpgo_tpu.losses import Loss, loss_value, loss_weight
from dpgo_tpu.objective import (EdgeData, evaluate_f, evaluate_euclidean_grad,
                                evaluate_riemannian_grad)
from dpgo_tpu.graph import make_partition
from dpgo_tpu.ops.so3 import polar_so3
from dpgo_tpu.ops.so3_triton import polar_so3_triton

from tests.synthetic import random_pose_graph


def brute_force_project(A):
    U, s, Vt = np.linalg.svd(A)
    flip = np.ones(A.shape[0])
    R = np.einsum("nik,nkj->nij", U, Vt)
    det = np.linalg.det(R)
    Up = U.copy()
    Up[det < 0, :, -1] *= -1
    return np.einsum("nik,nkj->nij", Up, Vt)


def well_conditioned_3x3(rng, n, neg_share):
    """U diag(s) V^T with separated singular values (so the projection is
    well conditioned) and det < 0 for a `neg_share` fraction."""
    def rot(k):
        q, r = np.linalg.qr(rng.normal(size=(k, 3, 3)))
        q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
        q[np.linalg.det(q) < 0, :, 0] *= -1
        return q
    s = np.stack([rng.uniform(1.0, 2.0, n), rng.uniform(0.5, 0.8, n),
                  rng.uniform(0.1, 0.3, n)], axis=1)
    s[rng.random(n) < neg_share, 2] *= -1
    return np.einsum("nab,nb,ncb->nac", rot(n), s, rot(n))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.float64, 1e-12)])
@pytest.mark.parametrize("n", [5, 3000])
@pytest.mark.parametrize("neg_share", [0.2, 1.0])
def test_project_so3_batch_matches_svd(rng, dtype, tol, n, neg_share):
    """d = 3 projection (ops/so3.polar_so3) against float64 SVD over batch
    sizes and shares of det < 0 inputs, in both working precisions."""
    A = well_conditioned_3x3(rng, n, neg_share)
    R = np.asarray(jax.jit(manifold.project_sod)(jnp.asarray(A, dtype)))
    assert R.dtype == np.dtype(dtype)
    np.testing.assert_allclose(R, brute_force_project(A), atol=tol)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.float64, 1e-12)])
@pytest.mark.parametrize("lead", [(5,), (3, 100)])
def test_polar_so3_triton_interpret_matches_svd(rng, dtype, tol, lead):
    """The GPU kernel, run in Pallas' interpreter, against float64 SVD and
    the plain jnp body, with batches that do not fill the last block and
    leading batch axes."""
    n = int(np.prod(lead))
    A = well_conditioned_3x3(rng, n, 0.3).reshape(*lead, 3, 3)
    R = np.asarray(polar_so3_triton(jnp.asarray(A, dtype), interpret=True))
    assert R.shape == A.shape and R.dtype == np.dtype(dtype)
    np.testing.assert_allclose(R.reshape(n, 3, 3),
                               brute_force_project(A.reshape(n, 3, 3)),
                               atol=tol)
    np.testing.assert_allclose(
        R, np.asarray(polar_so3(jnp.asarray(A, dtype))), atol=tol)


@pytest.mark.parametrize("d", [2, 3])
def test_project_sod_matches_svd(rng, d):
    A = rng.normal(size=(50, d, d))
    R = np.asarray(manifold.project_sod(jnp.asarray(A)))
    R_ref = brute_force_project(A)
    np.testing.assert_allclose(R, R_ref, atol=1e-10)
    # Valid rotations.
    np.testing.assert_allclose(
        np.einsum("nki,nkj->nij", R, R), np.tile(np.eye(d), (50, 1, 1)),
        atol=1e-10)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-10)


@pytest.mark.parametrize("d", [2, 3])
def test_project_sod_is_argmax(rng, d):
    # project(A) maximizes <R, A> over SO(d): compare against random rotations.
    A = rng.normal(size=(20, d, d))
    R = np.asarray(manifold.project_sod(jnp.asarray(A)))
    best = np.einsum("nij,nij->n", R, A)
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        Rr = np.asarray(manifold.random_rotations(key, 20, d))
        other = np.einsum("nij,nij->n", Rr, A)
        assert np.all(best >= other - 1e-9)


def test_proj_tangent_properties(rng):
    d, n = 3, 30
    R = brute_force_project(rng.normal(size=(n, d, d)))
    V = rng.normal(size=(n, d, d))
    P = np.asarray(manifold.proj_tangent(jnp.asarray(R), jnp.asarray(V)))
    # Tangent vectors at R are R @ skew: R^T P must be skew-symmetric.
    RtP = np.einsum("nki,nkj->nij", R, P)
    np.testing.assert_allclose(RtP, -RtP.transpose(0, 2, 1), atol=1e-10)
    # Idempotent.
    P2 = np.asarray(manifold.proj_tangent(jnp.asarray(R), jnp.asarray(P)))
    np.testing.assert_allclose(P, P2, atol=1e-10)
    # Orthogonal: <V - P, P> = 0.
    assert abs(np.sum((V - P) * P)) < 1e-8


def _objective_loop(meas, t, R, loss=Loss.TRIVIAL, c=1.0, node_of=None):
    """Straightforward per-edge python-loop objective (test oracle)."""
    total = 0.0
    for k in range(len(meas)):
        i, j = meas.i[k], meas.j[k]
        rt = t[i] + R[i] @ meas.t[k] - t[j]
        rR = R[i] @ meas.R[k] - R[j]
        s = meas.tau[k] * rt @ rt + meas.kappa[k] * np.sum(rR * rR)
        if loss != Loss.TRIVIAL and node_of is not None \
                and node_of[i] != node_of[j]:
            s = float(loss_value(loss, jnp.asarray(s), c))
        total += 0.5 * s
    return total


@pytest.mark.parametrize("d", [2, 3])
def test_objective_matches_loop(rng, d):
    meas, t_true, R_true = random_pose_graph(rng, num_poses=25, d=d)
    t = t_true + rng.normal(size=t_true.shape) * 0.1
    R = brute_force_project(R_true + rng.normal(size=R_true.shape) * 0.1)
    edges = EdgeData.from_measurements(meas)
    f = float(evaluate_f(edges, jnp.asarray(t), jnp.asarray(R)))
    f_ref = _objective_loop(meas, t, R)
    np.testing.assert_allclose(f, f_ref, rtol=1e-12)


@pytest.mark.parametrize("loss", [Loss.HUBER, Loss.GEMAN_MCCLURE, Loss.WELSCH])
def test_objective_robust_matches_loop(rng, loss):
    meas, t_true, R_true = random_pose_graph(rng, num_poses=24, d=3)
    part = make_partition(meas.num_poses, 3)
    t = t_true + rng.normal(size=t_true.shape) * 0.3
    R = brute_force_project(R_true + rng.normal(size=R_true.shape) * 0.3)
    edges = EdgeData.from_measurements(meas, node_of=part.node_of)
    f = float(evaluate_f(edges, jnp.asarray(t), jnp.asarray(R),
                         loss=loss, loss_reg=0.25))
    f_ref = _objective_loop(meas, t, R, loss=loss, c=0.25,
                            node_of=part.node_of)
    np.testing.assert_allclose(f, f_ref, rtol=1e-10)


@pytest.mark.parametrize("loss", [Loss.TRIVIAL, Loss.HUBER, Loss.WELSCH])
def test_euclidean_grad_matches_autodiff(rng, loss):
    meas, t_true, R_true = random_pose_graph(rng, num_poses=20, d=3)
    part = make_partition(meas.num_poses, 2)
    edges = EdgeData.from_measurements(meas, node_of=part.node_of)
    t = jnp.asarray(t_true + rng.normal(size=t_true.shape) * 0.2)
    R = jnp.asarray(
        brute_force_project(R_true + rng.normal(size=R_true.shape) * 0.2))

    def f(tR):
        return evaluate_f(edges, tR[0], tR[1], loss=loss, loss_reg=0.25)

    gt_auto, gR_auto = jax.grad(f)((t, R))
    gt, gR = evaluate_euclidean_grad(edges, t, R, loss=loss, loss_reg=0.25)
    np.testing.assert_allclose(np.asarray(gt), np.asarray(gt_auto), atol=1e-9)
    np.testing.assert_allclose(np.asarray(gR), np.asarray(gR_auto), atol=1e-9)


def test_riemannian_grad_zero_at_optimum(rng):
    # Noise-free graph: ground truth is a global optimum -> grad = 0.
    meas, t_true, R_true = random_pose_graph(rng, num_poses=15, d=3, noise=0.0)
    edges = EdgeData.from_measurements(meas)
    f = float(evaluate_f(edges, jnp.asarray(t_true), jnp.asarray(R_true)))
    assert f < 1e-16
    gt, gR = evaluate_riemannian_grad(edges, jnp.asarray(t_true),
                                      jnp.asarray(R_true))
    assert float(jnp.abs(gt).max()) < 1e-9
    assert float(jnp.abs(gR).max()) < 1e-9


def test_loss_weight_is_derivative():
    s = jnp.linspace(0.01, 4.0, 100)
    for loss in [Loss.HUBER, Loss.GEMAN_MCCLURE, Loss.WELSCH]:
        dval = jax.vmap(jax.grad(lambda x: loss_value(loss, x, 0.25)))(s)
        w = loss_weight(loss, s, 0.25)
        np.testing.assert_allclose(np.asarray(dval), np.asarray(w), atol=1e-10)
