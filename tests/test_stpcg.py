"""Trust-region CG (tnt.stpcg) on a dense node model against a numpy float64
Steihaug-Toint reference, and with_weights' reduced-operator refresh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.synthetic import random_pose_graph


def _node_problem(rng, d, num_poses=40, steps=3):
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    meas, _, _ = random_pose_graph(rng, num_poses=num_poses, d=d,
                                   loop_closures=30, noise=0.05)
    s = DPGOSolver(meas, num_nodes=2, opts=MMOptions(accelerated=True),
                   dtype=jnp.float64)
    st, _ = s.run_steps(s.initialize(), jnp.zeros((), jnp.int32), steps)
    p = jax.tree.map(lambda x: x[0], s.probs)
    return meas, s, st, p


def _np_sym_block(A, B, C, d):
    """Per [d, d] block of tall storage: sym(B_i C_i^T) A_i."""
    Ab, Bb, Cb = (x.reshape(-1, d, d) for x in (A, B, C))
    S = np.einsum("nar,nbr->nab", Bb, Cb)
    S = 0.5 * (S + np.swapaxes(S, -1, -2))
    return np.einsum("nab,nbr->nar", S, Ab).reshape(A.shape)


def _np_steihaug_toint(g, hess, precon, Delta, kappa_fgr, theta, max_iters):
    """Textbook Steihaug-Toint truncated preconditioned CG (Conn, Gould &
    Toint, Trust-Region Methods, Alg. 7.5.1) with the reference's
    relative-residual stop r0 min(kappa, r0^theta). Returns (step,
    iterations, step norm in the preconditioner metric)."""
    s = np.zeros_like(g)
    r = g.copy()
    v = precon(r)
    p = -v
    rv = float(np.sum(r * v))
    r0 = np.sqrt(rv)
    target = r0 * min(kappa_fgr, r0 ** theta)
    sMp, sMs, pMp = 0.0, 0.0, rv
    if r0 <= target:
        return s, 0, 0.0
    for k in range(max_iters):
        Hp = hess(p)
        curv = float(np.sum(p * Hp))
        alpha = rv / curv
        sMs_next = sMs + 2 * alpha * sMp + alpha * alpha * pMp
        if curv <= 0 or sMs_next > Delta * Delta:
            sigma = (-sMp + np.sqrt(sMp * sMp + pMp * (Delta ** 2 - sMs))) \
                / pMp
            return s + sigma * p, k + 1, Delta
        s = s + alpha * p
        r = r + alpha * Hp
        v = precon(r)
        rv_new = float(np.sum(r * v))
        beta = rv_new / rv
        sMp = beta * (sMp + alpha * pMp)
        pMp = rv_new + beta * beta * pMp
        sMs = sMs_next
        p = -v + beta * p
        rv = rv_new
        if np.sqrt(rv) <= target:
            return s, k + 1, np.sqrt(sMs)
    return s, max_iters, np.sqrt(sMs)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("Delta", [1e3, 1e-3])
def test_stpcg_matches_numpy_steihaug_toint(rng, d, Delta):
    """Interior convergence (large Delta) and the trust-region boundary
    exit (small Delta), d = 2 and 3, dense-preconditioned node model."""
    from dpgo_tpu.solvers.tnt import TNTParams, stpcg

    _, _, st, p = _node_problem(rng, d)
    Q = p.to_tall(st.Z.R[0])
    nabla = p.reduced_grad_tall(st.Z.t[0], Q, p.to_tall(st.g_R[0]))
    grad = p.proj_tall(Q, nabla)
    params = TNTParams()
    h, Hh, nrm, k = stpcg(grad, lambda v: p.hessian_vp_tall(Q, nabla, v),
                          lambda v: p.precondition_tall(Q, v),
                          jnp.asarray(Delta, jnp.float64), params)

    Qn, nab, Hred, Pd = (np.asarray(x, np.float64)
                         for x in (Q, nabla, p.Hred_d, p.precon_dense))
    proj = lambda V: V - _np_sym_block(Qn, Qn, V, d)
    hess = lambda V: proj(Hred @ V - _np_sym_block(V, Qn, nab, d))
    precon = lambda V: proj(Pd @ V)
    h_ref, k_ref, nrm_ref = _np_steihaug_toint(
        np.asarray(grad), hess, precon, Delta, params.kappa_fgr,
        params.theta, params.max_tCG_iterations)

    assert int(k) == k_ref
    assert k_ref >= 1
    np.testing.assert_allclose(np.asarray(h), h_ref, rtol=1e-8,
                               atol=1e-10 * np.abs(h_ref).max())
    np.testing.assert_allclose(np.asarray(Hh), hess(h_ref), rtol=1e-7,
                               atol=1e-9 * np.abs(hess(h_ref)).max())
    np.testing.assert_allclose(float(nrm), nrm_ref, rtol=1e-8)


def test_with_weights_refreshes_reduced_operator(rng):
    """with_weights' on-device Hred_d update equals the reduced operator of a
    problem rebuilt from measurements whose inter edges carry the weights:
    hessian_vp_tall agrees between the two."""
    from dpgo_tpu.graph import build_multigraph
    from dpgo_tpu.problem import build_node_problems, with_weights

    meas, s, st, p = _node_problem(rng, 3)
    node_of = s.part.node_of
    inter0 = np.nonzero((node_of[meas.i] == 0) != (node_of[meas.j] == 0))[0]
    m1 = int(np.asarray(p.e_self).shape[0])
    w = np.ones(m1)
    w[:len(inter0)] = rng.uniform(0.2, 1.0, size=len(inter0))
    pw = with_weights(p, jnp.asarray(w))

    scaled = meas.select(np.arange(len(meas)))
    scaled.kappa = scaled.kappa.copy()
    scaled.tau = scaled.tau.copy()
    scaled.kappa[inter0] *= w[:len(inter0)]
    scaled.tau[inter0] *= w[:len(inter0)]
    _, _, mg = build_multigraph(scaled, 2)
    pr = jax.tree.map(lambda x: x[0], build_node_problems(
        mg, xi=s.opts.regularizer, dtype=jnp.float64))

    Q = p.to_tall(st.Z.R[0])
    nabla = jnp.asarray(rng.normal(size=Q.shape))
    V = p.proj_tall(Q, jnp.asarray(rng.normal(size=Q.shape)))
    out_w = np.asarray(pw.hessian_vp_tall(Q, nabla, V))
    out_r = np.asarray(pr.hessian_vp_tall(Q, nabla, V))
    out_0 = np.asarray(p.hessian_vp_tall(Q, nabla, V))
    assert np.abs(out_0 - out_r).max() > 1e-3 * np.abs(out_r).max()
    np.testing.assert_allclose(out_w, out_r, rtol=1e-7,
                               atol=1e-8 * np.abs(out_r).max())
