"""Tests for the per-node MM surrogate operators (problem.py).

The oracles are (a) jax autodiff of directly-written objective functions and
(b) the algebraic MM certificates: sum of node surrogates majorizes the global
objective with equality/tangency at the anchor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu.graph import build_multigraph
from dpgo_tpu.losses import Loss
from dpgo_tpu.manifold import project_sod, proj_tangent
from dpgo_tpu.objective import EdgeData, evaluate_f
from dpgo_tpu.problem import NodeProblem, NodeState, build_node_problems

from tests.synthetic import random_pose_graph


def make_problem(rng, num_poses=36, d=3, num_nodes=3, xi=1e-3):
    meas, t_true, R_true = random_pose_graph(rng, num_poses=num_poses, d=d,
                                             loop_closures=20)
    part, nodes, mg = build_multigraph(meas, num_nodes)
    probs = build_node_problems(mg, xi=xi)
    return meas, part, nodes, mg, probs


def global_to_states(mg, part, t, R):
    """Pack a global (t [P,d], R [P,d,d]) into per-node NodeStates."""
    tn = np.zeros((mg.num_nodes, mg.n0_max, mg.d))
    Rn = np.tile(np.eye(mg.d), (mg.num_nodes, mg.n0_max, 1, 1))
    for a in range(mg.num_nodes):
        n0 = int(mg.n0[a])
        s = int(mg.start[a])
        tn[a, :n0] = t[s:s + n0]
        Rn[a, :n0] = R[s:s + n0]
    gidx = mg.start[mg.halo_owner] + mg.halo_lpose  # [N, n1m] global ids
    th = t[gidx]
    Rh = R[gidx]
    return NodeState(t=jnp.asarray(tn), R=jnp.asarray(Rn),
                     th=jnp.asarray(th), Rh=jnp.asarray(Rh))


def rand_global(rng, meas):
    P, d = meas.num_poses, meas.d
    t = rng.normal(size=(P, d))
    R = np.asarray(project_sod(jnp.asarray(rng.normal(size=(P, d, d)))))
    return t, R


def node_prob(probs: NodeProblem, a: int) -> NodeProblem:
    return jax.tree.map(lambda x: x[a], probs)


def state_at(states: NodeState, a: int) -> NodeState:
    return jax.tree.map(lambda x: x[a], states)


def test_sum_local_fobj_equals_global(rng):
    meas, part, nodes, mg, probs = make_problem(rng)
    t, R = rand_global(rng, meas)
    states = global_to_states(mg, part, t, R)
    total = sum(float(node_prob(probs, a).local_fobj(state_at(states, a)))
                for a in range(mg.num_nodes))
    edges = EdgeData.from_measurements(meas)
    f_global = float(evaluate_f(edges, jnp.asarray(t), jnp.asarray(R)))
    np.testing.assert_allclose(total, f_global, rtol=1e-12)


def test_surrogate_touches_and_gradient_matches(rng):
    """At the anchor, G^a = F^a + xi-term*0 and grad G^a = grad F^a."""
    meas, part, nodes, mg, probs = make_problem(rng)
    t, R = rand_global(rng, meas)
    states = global_to_states(mg, part, t, R)
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        st = state_at(states, a)
        g, f = p.surrogate_g_f(st)
        G_at_anchor = float(p.evaluate_G(st.t, st.R, g, f))
        fobj = float(p.local_fobj(st))
        np.testing.assert_allclose(G_at_anchor, fobj, rtol=1e-10)

        # Gradient of G^a at the anchor equals nabla_a F of the *global*
        # objective (inter edges count fully; their other half lives in the
        # neighbor's surrogate). Autodiff oracle with the halo frozen:
        def local_F(tR):
            sx = st.with_own(tR[0], tR[1])
            rt, rR = p.intra_residuals(sx.t, sx.R)
            val = 0.5 * (jnp.sum(rt * rt) + jnp.sum(rR * rR))
            (u_s, E_s), (u_o, E_o) = p.inter_halves(sx)
            u = u_s + u_o
            E = E_s + E_o
            return val + 0.5 * (jnp.sum(u * u) + jnp.sum(E * E))

        gt_auto, gR_auto = jax.grad(local_F)((st.t, st.R))
        Df_t, Df_R = p.euclidean_Df(st, g=g)
        np.testing.assert_allclose(np.asarray(Df_t), np.asarray(gt_auto),
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(Df_R), np.asarray(gR_auto),
                                   atol=1e-9)


def test_surrogate_majorizes_globally(rng):
    """sum_a G^a(X_a|Z) >= F(X) + xi/2 |X - Z|^2, equality at X = Z."""
    meas, part, nodes, mg, probs = make_problem(rng, xi=1e-6)
    tz, Rz = rand_global(rng, meas)
    zstates = global_to_states(mg, part, tz, Rz)
    edges = EdgeData.from_measurements(meas)
    for trial in range(5):
        tx, Rx = rand_global(rng, meas)
        xstates = global_to_states(mg, part, tx, Rx)
        total_G = 0.0
        for a in range(mg.num_nodes):
            p = node_prob(probs, a)
            g, f = p.surrogate_g_f(state_at(zstates, a))
            sx = state_at(xstates, a)
            total_G += float(p.evaluate_G(sx.t, sx.R, g, f))
        f_global = float(evaluate_f(edges, jnp.asarray(tx), jnp.asarray(Rx)))
        assert total_G >= f_global - 1e-8


def test_q_gap_telescoping(rng):
    """The telescoped per-node objective fobj' = G^a(X'|Z) + 1/2 <Q dZ, dZ>
    sums to the exact global objective across nodes (per-node values carry an
    antisymmetric inter-edge correction that cancels pairwise), and the
    next-surrogate constant f' = fobj' + 1/2 <P Z', Z'> reproduces a valid
    anchored surrogate (its value at the new anchor equals fobj')."""
    meas, part, nodes, mg, probs = make_problem(rng)
    tz, Rz = rand_global(rng, meas)
    tx, Rx = rand_global(rng, meas)
    zs = global_to_states(mg, part, tz, Rz)
    xs = global_to_states(mg, part, tx, Rx)
    edges = EdgeData.from_measurements(meas)
    f_global = float(evaluate_f(edges, jnp.asarray(tx), jnp.asarray(Rx)))
    total = 0.0
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        za, xa = state_at(zs, a), state_at(xs, a)
        g, f = p.surrogate_g_f(za)
        G_val = float(p.evaluate_G(xa.t, xa.R, g, f))
        dstate = jax.tree.map(lambda x, z: x - z, xa, za)
        fobj_new = G_val + float(p.q_gap(dstate))
        total += fobj_new
        # New anchored surrogate from the telescoped constant:
        g2, _ = p.surrogate_g_f(xa)
        f2 = fobj_new + float(p.p_form(xa))
        G2_at_anchor = float(p.evaluate_G(xa.t, xa.R, g2, f2))
        np.testing.assert_allclose(G2_at_anchor, fobj_new, rtol=1e-9)
    # xi-proximal terms vanish at the anchor; corrections cancel globally.
    np.testing.assert_allclose(total, f_global, rtol=1e-9)


def aux_surrogate_value(p: NodeProblem, z: NodeState, t, R):
    """Direct construction of the auxiliary surrogate H^a(X|Z) (up to the
    constant F^a(Z)): 1/2 <H dX, dX> + <Df, dX> with dX = X - Z_a."""
    Df_t, Df_R = p.euclidean_Df(z)
    dt = t - z.t
    dR = R - z.R
    # <H dX, dX> = sum_p DiagT_p |dt_p|^2 + 2 dt_p^T dR_p nvec_p
    #              + <dR_p S_p, dR_p>, with S = W + T nvec nvec^T.
    S = p.W + p.diagT_inv[:, None, None] * \
        p.nvec[:, :, None] * p.nvec[:, None, :]
    quad = jnp.sum((1.0 / p.diagT_inv) * jnp.sum(dt * dt, -1))
    quad += 2.0 * jnp.sum(dt * jnp.einsum("pab,pb->pa", dR, p.nvec))
    quad += jnp.sum(jnp.einsum("pab,pbc->pac", dR, S) * dR)
    lin = jnp.sum(Df_t * dt) + jnp.sum(Df_R * dR)
    return 0.5 * quad + lin


def test_proximal_minimizes_auxiliary_surrogate(rng):
    meas, part, nodes, mg, probs = make_problem(rng, xi=1e-3)
    t, R = rand_global(rng, meas)
    zs = global_to_states(mg, part, t, R)
    key = jax.random.PRNGKey(0)
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        z = state_at(zs, a)
        Df = p.euclidean_Df(z)
        t_new, R_new = p.proximal(z, Df)
        val = float(aux_surrogate_value(p, z, t_new, R_new))
        # Any other feasible candidate must not beat it.
        for seed in range(8):
            key, k1, k2 = jax.random.split(key, 3)
            R_cand = project_sod(z.R + 0.3 * jax.random.normal(
                k1, z.R.shape, dtype=z.R.dtype))
            t_cand = z.t + 0.3 * jax.random.normal(
                k2, z.t.shape, dtype=z.t.dtype)
            cand = float(aux_surrogate_value(p, z, t_cand, R_cand))
            assert val <= cand + 1e-9
        # t+ satisfies the first-order condition of H in t exactly:
        # DiagT (t - z_t) + dR nvec + Df_t = 0.
        res = (1.0 / p.diagT_inv)[:, None] * (t_new - z.t) \
            + jnp.einsum("pab,pb->pa", R_new - z.R, p.nvec) + Df[0]
        assert float(jnp.abs(res).max()) < 1e-9
        # The proximal step decreases the auxiliary surrogate (<= 0 at z).
        assert val <= 1e-12


def test_recover_translations_optimality(rng):
    """mG00 t + mG01 R + g_t = 0 at recovered t -> dG/dt = 0 (autodiff)."""
    meas, part, nodes, mg, probs = make_problem(rng, xi=1e-3)
    t, R = rand_global(rng, meas)
    zs = global_to_states(mg, part, t, R)
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        z = state_at(zs, a)
        g, f = p.surrogate_g_f(z)
        R_arb = project_sod(z.R + 0.2 * np.asarray(
            jax.random.normal(jax.random.PRNGKey(a), z.R.shape)))
        t_rec = p.recover_translations(R_arb, g[0])

        def G_of_t(tv):
            return p.evaluate_G(tv, R_arb, g, f)

        grad_t = jax.grad(G_of_t)(t_rec)
        assert float(jnp.abs(grad_t).max()) < 1e-8


def test_G_apply_matches_autodiff(rng):
    meas, part, nodes, mg, probs = make_problem(rng)
    t, R = rand_global(rng, meas)
    zs = global_to_states(mg, part, t, R)
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        z = state_at(zs, a)

        def quad(tR):
            return 0.5 * p.G_quad(tR[0], tR[1])

        gt_auto, gR_auto = jax.grad(quad)((z.t, z.R))
        Gt, GR = p.G_apply(z.t, z.R)
        np.testing.assert_allclose(np.asarray(Gt), np.asarray(gt_auto),
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(GR), np.asarray(gR_auto),
                                   atol=1e-9)


def test_mg_blocks_match_G_apply(rng):
    """mG00/mG01/mG10/mG11 block operators assemble to G_apply."""
    meas, part, nodes, mg, probs = make_problem(rng, xi=1e-4)
    t, R = rand_global(rng, meas)
    zs = global_to_states(mg, part, t, R)
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        z = state_at(zs, a)
        M = np.asarray(jax.random.normal(jax.random.PRNGKey(a),
                                         z.R.shape))
        v = np.asarray(jax.random.normal(jax.random.PRNGKey(100 + a),
                                         z.t.shape))
        Gt, GR = p.G_apply(jnp.asarray(v), jnp.asarray(M))
        # translation row: mG00 v + mG01 M, with mG00 v = G_apply(v, 0).t
        mG00v, _ = p.G_apply(jnp.asarray(v), jnp.zeros_like(jnp.asarray(M)))
        top = mG00v + p.mG01_apply(jnp.asarray(M))
        np.testing.assert_allclose(np.asarray(top), np.asarray(Gt),
                                   atol=1e-7)
        # rotation row: mG10 v + mG11 M
        bot = p.mG10_apply(jnp.asarray(v)) + p.mG11_apply(jnp.asarray(M))
        np.testing.assert_allclose(np.asarray(bot), np.asarray(GR),
                                   atol=1e-8)
        # The split inverse really inverts mG00 = L + xi I.
        back = p.solve_mG00(mG00v)
        np.testing.assert_allclose(np.asarray(back), v, atol=1e-7)


def test_hessian_vp_symmetric_and_fd(rng):
    meas, part, nodes, mg, probs = make_problem(rng, xi=1e-4)
    t, R = rand_global(rng, meas)
    zs = global_to_states(mg, part, t, R)
    p = node_prob(probs, 0)
    z = state_at(zs, 0)
    g, f = p.surrogate_g_f(z)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    V1 = proj_tangent(z.R, jax.random.normal(k1, z.R.shape, dtype=z.R.dtype))
    V2 = proj_tangent(z.R, jax.random.normal(k2, z.R.shape, dtype=z.R.dtype))
    t_of_R = lambda Rv: p.recover_translations(Rv, g[0])
    nablaR = p.reduced_euclidean_grad(t_of_R(z.R), z.R, g[1])
    H1 = p.reduced_hessian_vp(z.R, nablaR, V1)
    H2 = p.reduced_hessian_vp(z.R, nablaR, V2)
    ip1 = float(jnp.sum(H1 * V2))
    ip2 = float(jnp.sum(H2 * V1))
    np.testing.assert_allclose(ip1, ip2, rtol=1e-8, atol=1e-10)


def test_dense_operators_match_edgewise(rng):
    """The dense operator images agree with the edge-wise operators."""
    meas, part, nodes, mg, probs = make_problem(rng, xi=1e-4)
    t, R = rand_global(rng, meas)
    zs = global_to_states(mg, part, t, R)
    assert probs.dense
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        z = state_at(zs, a)
        Q = p.to_tall(z.R)
        # mG01 / mG11 actions.
        np.testing.assert_allclose(np.asarray(p.mG01_d @ Q),
                                   np.asarray(p.mG01_apply(z.R)), atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(p.from_tall(p.mG11_d @ Q)),
            np.asarray(p.mG11_apply(z.R)), atol=1e-9)
        v = np.asarray(jax.random.normal(jax.random.PRNGKey(a), z.t.shape))
        np.testing.assert_allclose(
            np.asarray(p.from_tall(p.mG01_d.T @ jnp.asarray(v))),
            np.asarray(p.mG10_apply(jnp.asarray(v))), atol=1e-9)
        # Surrogate value parity.
        g, f = p.surrogate_g_f(z)
        val_dense = float(p.evaluate_G_tall(z.t, Q, g[0], p.to_tall(g[1]), f))
        val_edge = float(p.evaluate_G(z.t, z.R, g, f))
        np.testing.assert_allclose(val_dense, val_edge, rtol=1e-10)
        # Hessian-vp parity.
        V = proj_tangent(z.R, jax.random.normal(jax.random.PRNGKey(7 + a),
                                                z.R.shape, dtype=z.R.dtype))
        nabla_e = p.reduced_euclidean_grad(z.t, z.R, g[1])
        h_edge = p.reduced_hessian_vp(z.R, nabla_e, V)
        nabla_d = p.reduced_grad_tall(z.t, Q, p.to_tall(g[1]))
        h_dense = p.from_tall(p.hessian_vp_tall(Q, nabla_d, p.to_tall(V)))
        np.testing.assert_allclose(np.asarray(h_dense), np.asarray(h_edge),
                                   atol=1e-8)


def test_evaluate_G_relative_form(rng):
    """The relative surrogate evaluation (a) touches fobj exactly at X = Z
    (tangency by construction) and (b) has the same value DIFFERENCES as the
    absolute form 1/2<GX,X> + <g,X> + f — the two anchor G to different
    per-node constants (telescoped vs direct objective), but every solver
    decision consumes only differences against fobj-derived sequences."""
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions, _eval_G_batch
    meas, _, _ = random_pose_graph(rng, num_poses=40, d=3)
    s = DPGOSolver(meas, num_nodes=3, opts=MMOptions(accelerated=True))
    st = s.initialize()
    # Tangency: G_rel(Z|Z) == fobj bit-exactly up to the O(delta)=0 terms.
    G_at_Z = _eval_G_batch(s.probs, st, st.Z.t, st.Z.R)
    np.testing.assert_allclose(np.asarray(G_at_Z), np.asarray(st.fobj),
                               rtol=1e-13)
    # Difference equality vs the absolute form, at two candidates.
    def absG(t, R):
        return jax.vmap(
            lambda p, a, b, c, d_, e: p.evaluate_G(a, b, (c, d_), e))(
            s.probs, t, R, st.g_t, st.g_R, st.f)

    # Perturb REAL poses only: padded slots are decoupled from all edges but
    # carry different (equally irrelevant) diagonal regularizers in the
    # dense (+1) vs edge-wise (xi) forms.
    pm_t = np.asarray(s.probs.pose_mask)[:, :, None]
    pm_R = pm_t[..., None]
    xt = st.Z.t + 0.01 * pm_t * jnp.asarray(rng.normal(size=st.Z.t.shape))
    xR = st.Z.R + 0.01 * pm_R * jnp.asarray(rng.normal(size=st.Z.R.shape))
    yt = st.Z.t + 0.01 * pm_t * jnp.asarray(rng.normal(size=st.Z.t.shape))
    yR = st.Z.R + 0.01 * pm_R * jnp.asarray(rng.normal(size=st.Z.R.shape))
    d_rel = np.asarray(_eval_G_batch(s.probs, st, xt, xR)
                       - _eval_G_batch(s.probs, st, yt, yR))
    d_abs = np.asarray(absG(xt, xR) - absG(yt, yR))
    np.testing.assert_allclose(d_rel, d_abs, rtol=1e-7, atol=1e-10)


def test_surrogate_g_f_fobj_fused(rng):
    """Fused (g, f, fobj) equals the separate surrogate_g_f + local_fobj."""
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.graph import build_multigraph
    from dpgo_tpu.problem import build_node_problems, NodeState
    import jax
    meas, _, _ = random_pose_graph(rng, num_poses=24, d=3, loop_closures=12)
    _, _, mg = build_multigraph(meas, 3)
    for loss in (Loss.TRIVIAL, Loss.HUBER):
        probs = build_node_problems(mg, loss=loss, loss_reg=0.5)
        t = rng.normal(size=(3, mg.n0_max, 3))
        R = np.linalg.qr(rng.normal(size=(3, mg.n0_max, 3, 3)))[0]
        th = rng.normal(size=(3, mg.n1_max, 3))
        Rh = np.linalg.qr(rng.normal(size=(3, mg.n1_max, 3, 3)))[0]
        Z = NodeState(t=jnp.asarray(t), R=jnp.asarray(R),
                      th=jnp.asarray(th), Rh=jnp.asarray(Rh))
        def one(p, z):
            g, f, fobj = p.surrogate_g_f_fobj(z)
            g2, f2 = p.surrogate_g_f(z)
            fobj2 = p.local_fobj(z)
            return (g[0] - g2[0], g[1] - g2[1], f - f2, fobj - fobj2)
        outs = jax.vmap(one)(probs, Z)
        for o in outs:
            np.testing.assert_allclose(np.asarray(o), 0.0, atol=1e-10)


def test_evaluate_G_tall_rel_matches_absolute(rng):
    """The f32-stable relative tall-storage surrogate value (anchored at Z,
    where tangency gives G(Z|Z) = fobj) has the same DIFFERENCES as the
    absolute dense form, and touches fobj exactly at X = Z."""
    meas, part, nodes, mg, probs = make_problem(rng, xi=1e-4)
    t, R = rand_global(rng, meas)
    zs = global_to_states(mg, part, t, R)
    for a in range(mg.num_nodes):
        p = node_prob(probs, a)
        z = state_at(zs, a)
        g, f = p.surrogate_g_f(z)
        fobj = float(p.local_fobj(z))
        zQ = p.to_tall(z.R)
        gQ = p.to_tall(g[1])
        # Tangency at the anchor.
        v0 = float(p.evaluate_G_tall_rel(z.t, zQ, z.t, zQ, g[0], gQ, fobj))
        np.testing.assert_allclose(v0, fobj, rtol=1e-12)
        # Differences match the absolute form for random perturbations.
        key = jax.random.PRNGKey(11 + a)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        xt1 = z.t + 0.1 * jax.random.normal(k1, z.t.shape, dtype=z.t.dtype)
        xQ1 = zQ + 0.1 * jax.random.normal(k2, zQ.shape, dtype=zQ.dtype)
        xt2 = z.t + 0.1 * jax.random.normal(k3, z.t.shape, dtype=z.t.dtype)
        xQ2 = zQ + 0.1 * jax.random.normal(k4, zQ.shape, dtype=zQ.dtype)
        rel1 = float(p.evaluate_G_tall_rel(xt1, xQ1, z.t, zQ, g[0], gQ,
                                           fobj))
        rel2 = float(p.evaluate_G_tall_rel(xt2, xQ2, z.t, zQ, g[0], gQ,
                                           fobj))
        abs1 = float(p.evaluate_G_tall(xt1, xQ1, g[0], gQ, f))
        abs2 = float(p.evaluate_G_tall(xt2, xQ2, g[0], gQ, f))
        np.testing.assert_allclose(rel1 - rel2, abs1 - abs2,
                                   rtol=1e-9, atol=1e-9)
