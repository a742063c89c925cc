"""End-to-end solver integration tests (MM-PGO / AMM-PGO#)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu.driver import DPGOSolver
from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.solvers.mm import MMOptions, _make_tnt_model
from dpgo_tpu.solvers.tnt import tnt, TNTParams

from tests.conftest import dataset_path
from tests.synthetic import random_pose_graph


def test_mm_monotone_decrease_csail():
    meas = read_g2o_file(dataset_path("CSAIL.g2o"))
    solver = DPGOSolver(meas, num_nodes=1, opts=MMOptions(accelerated=False))
    st, hist = solver.run(15)
    fobj = hist[:, 1]
    # MM-PGO is monotone (up to fp noise).
    assert np.all(np.diff(fobj) <= 1e-9)
    assert fobj[-1] < fobj[0]


def test_amm_converges_tiny3d_two_nodes():
    meas = read_g2o_file(dataset_path("tinyGrid3D.g2o"))
    solver = DPGOSolver(meas, num_nodes=2, opts=MMOptions(accelerated=True))
    st, hist = solver.run(100, record_every=100)
    assert hist[-1, 2] < 1e-2          # gradient norm nearly zero
    assert hist[-1, 1] < hist[0, 1]    # objective decreased


def test_partition_count_invariance_synthetic(rng):
    """The converged objective must not depend on the partition count."""
    meas, _, _ = random_pose_graph(rng, num_poses=30, d=2, loop_closures=15,
                                   noise=0.05)
    finals = []
    for nodes in (1, 3):
        solver = DPGOSolver(meas, num_nodes=nodes,
                            opts=MMOptions(accelerated=True))
        st, hist = solver.run(150, record_every=150)
        finals.append(hist[-1, 1])
    np.testing.assert_allclose(finals[0], finals[1], rtol=1e-4)


def test_full_tnt_oracle_matches_amm_direction():
    """A long unrestricted TNT solve on the single-node surrogate reaches a
    first-order critical point of the full problem; AMM approaches its value
    from above."""
    meas = read_g2o_file(dataset_path("tinyGrid3D.g2o"))
    solver = DPGOSolver(meas, num_nodes=1, opts=MMOptions(accelerated=True))
    st0 = solver.initialize()
    p = jax.tree.map(lambda x: x[0], solver.probs)
    g = (st0.g_t[0], st0.g_R[0])
    model = _make_tnt_model(p, g[0], g[1], st0.f[0])
    params = TNTParams(max_iterations=200, max_iterations_accepted=200,
                       gradient_tolerance=1e-8,
                       preconditioned_gradient_tolerance=1e-10,
                       relative_decrease_tolerance=1e-15,
                       stepsize_tolerance=1e-10, Delta_tolerance=1e-12)
    Z = jax.tree.map(lambda x: x[0], st0.Z)
    tn, Rn, fx, gn, acc = tnt(model, Z.t, Z.R, params)
    assert float(gn) < 1e-5
    st, hist = solver.run(80, record_every=80)
    # AMM approaches the critical value from above.
    assert hist[-1, 1] >= 2 * float(fx) - 1e-6
    assert hist[-1, 1] - 2 * float(fx) < 0.05 * abs(float(fx))


def test_amm_restart_machinery_touched():
    """Longer AMM run on a noisy graph exercises restarts without blowing up."""
    rng = np.random.default_rng(3)
    meas, _, _ = random_pose_graph(rng, num_poses=40, d=3, loop_closures=30,
                                   noise=0.2)
    solver = DPGOSolver(meas, num_nodes=4, opts=MMOptions(accelerated=True))
    st, hist = solver.run(120, record_every=10)
    assert np.all(np.isfinite(hist))
    # Objective sequence is near-monotone (AMM allows tiny bumps but the
    # restart machinery must keep it controlled).
    assert hist[-1, 1] <= hist[0, 1]
    assert hist[-1, 1] <= np.min(hist[:, 1]) + 1e-6


def test_star_solver_matches_hash_on_easy_graph():
    """AMM-PGO* and AMM-PGO# coincide while no restart triggers."""
    from dpgo_tpu.driver import DPGOStarSolver
    meas = read_g2o_file(dataset_path("tinyGrid3D.g2o"))
    hash_solver = DPGOSolver(meas, num_nodes=2, opts=MMOptions())
    star_solver = DPGOStarSolver(meas, num_nodes=2, opts=MMOptions())
    _, hist_h = hash_solver.run(40, record_every=10)
    _, hist_s = star_solver.run(40, record_every=10)
    np.testing.assert_allclose(hist_s[:, 1], hist_h[:, 1], rtol=1e-6)
    assert hist_s[-1, 2] < 0.5


def test_device_scan_matches_per_step(rng):
    """run_steps / run_steps_history (one-dispatch device loops) reproduce
    the per-step stepping to rounding (separately compiled XLA programs may
    fuse sums differently — a few f64 ulp), including the restart state
    machine."""
    meas, _, _ = random_pose_graph(rng, num_poses=40, d=3)
    s = DPGOSolver(meas, num_nodes=3, opts=MMOptions(accelerated=True))
    st = s.initialize()
    st_a = st
    for k in range(10):
        st_a = s._step(st_a, jnp.asarray(k, jnp.int32))
    fa, ga = s._metrics(st_a)
    st_b, k0 = s.run_steps(st, jnp.zeros((), jnp.int32), 10)
    fb, gb = s._metrics(st_b)
    assert int(k0) == 10
    np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), rtol=1e-13,
                               atol=1e-13)
    st_c, _, (fh, gh) = s.run_steps_history(st, jnp.zeros((), jnp.int32), 10)
    assert fh.shape == (10,)
    # History metrics come from the per-node state (sum of node objectives /
    # rms of node gradients) — equal to the global edge-sum oracle up to
    # rounding.
    np.testing.assert_allclose(np.asarray(fh[-1]), np.asarray(fb),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(gh[-1]), np.asarray(gb),
                               rtol=1e-8, atol=1e-12)


def test_local_gauge_invariance():
    """Local (per-node block centroid) gauge centering leaves the f64
    trajectory unchanged: every cost/solver quantity is difference-based
    (only the xi = 1e-11 tie-breaker sees the frame)."""
    meas = read_g2o_file(dataset_path("CSAIL.g2o"))
    base = DPGOSolver(meas, num_nodes=4,
                      opts=MMOptions(accelerated=True, local_gauge=False))
    cent = DPGOSolver(meas, num_nodes=4,
                      opts=MMOptions(accelerated=True, local_gauge=True))
    st_b = base.initialize()
    st_c = cent.initialize()
    assert cent._c is not None and base._c is None
    k0 = jnp.zeros((), jnp.int32)
    st_b, _ = base.run_steps(st_b, k0, 30)
    st_c, _ = cent.run_steps(st_c, k0, 30)
    fb, gb = map(float, base._metrics(st_b))
    fc, gc = map(float, cent._metrics(st_c))
    np.testing.assert_allclose(fb, fc, rtol=1e-9)
    np.testing.assert_allclose(gb, gc, rtol=1e-6, atol=1e-9)
    tb, Rb = map(np.asarray, base.gather_global(st_b))
    tc, Rc = map(np.asarray, cent.gather_global(st_c))
    np.testing.assert_allclose(tb, tc, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(Rb, Rc, rtol=1e-7, atol=1e-8)


def test_edgewise_dense_path_parity():
    """The edge-wise (matrix-free) operator path — the fallback for blocks
    above dense_limit — matches the dense-operator path trajectory.

    TNT refinement is disabled: the two paths use different (equally valid)
    STPCG preconditioners, so refined trajectories legitimately diverge;
    the proximal/update math must agree to rounding."""
    opts = MMOptions(accelerated=True, tnt=TNTParams(max_iterations=0))
    meas = read_g2o_file(dataset_path("CSAIL.g2o"))
    dense = DPGOSolver(meas, num_nodes=4, opts=opts)
    edge = DPGOSolver(meas, num_nodes=4, opts=opts, dense_limit=0)
    assert dense.probs.dense and not edge.probs.dense
    st_d = dense.initialize()
    st_e = edge.initialize()
    k0 = jnp.zeros((), jnp.int32)
    st_d, _ = dense.run_steps(st_d, k0, 15)
    st_e, _ = edge.run_steps(st_e, k0, 15)
    fd, gd = map(float, dense._metrics(st_d))
    fe, ge = map(float, edge._metrics(st_e))
    np.testing.assert_allclose(fd, fe, rtol=1e-8)
    np.testing.assert_allclose(gd, ge, rtol=1e-5, atol=1e-8)


def test_single_node_f32_converges():
    """Regression: single-node (no inter edges) f32 used to oscillate at
    2f ~ 32-33 — the split-inverse null response (null^T rhs)/xi amplified
    f32 rounding by 1/xi = 1e11. The anchored null response (solve_mG00
    t_anchor) computes it exactly."""
    meas = read_g2o_file(dataset_path("CSAIL.g2o"))
    s = DPGOSolver(meas, num_nodes=1, opts=MMOptions(accelerated=False),
                   dtype=jnp.float32)
    st = s.initialize()
    st, _ = s.run_steps(st, jnp.zeros((), jnp.int32), 300)
    f, g = map(float, s._metrics(st))
    assert f < 31.75, f   # certified 2f* = 31.7037
    assert g < 2.0, g


def test_preconditioner_enum_variants():
    """The reference Preconditioner enum options (DPGO_types.h:35-40) all
    drive the refined solver to the same optimum; 'dense' (the
    RegularizedCholesky role) needs the fewest total CG iterations."""
    from dpgo_tpu.io.g2o import read_g2o_file
    from tests.conftest import dataset_path

    meas = read_g2o_file(dataset_path("CSAIL.g2o"))
    finals = {}
    for kind in ("dense", "jacobi", "none"):
        opts = MMOptions(accelerated=True, preconditioner=kind)
        s = DPGOSolver(meas, num_nodes=2, opts=opts)
        st = s.initialize()
        st, _ = s.run_steps(st, jnp.zeros((), jnp.int32), 40)
        f, _ = s._metrics(st)
        finals[kind] = float(f)
    for kind, f in finals.items():
        assert abs(f / 31.7037158836 - 1) < 1e-3, (kind, f)
    # invalid choice rejected
    import pytest
    from dpgo_tpu.solvers.mm import resolve_preconditioner
    with pytest.raises(ValueError):
        resolve_preconditioner(DPGOSolver(meas, 2).probs,
                               MMOptions(preconditioner="ichol"))
