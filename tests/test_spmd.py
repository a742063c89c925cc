"""shard_map SPMD path: numerics must match the vmapped simulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu.driver import DPGOSolver
from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.parallel.spmd import ShardedDPGOSolver
from dpgo_tpu.solvers.mm import MMOptions

from tests.conftest import dataset_path
from tests.synthetic import random_pose_graph


@pytest.mark.parametrize("accelerated,halo", [(False, "boundary"),
                                              (True, "boundary"),
                                              (True, "gather"),
                                              (True, "ring")])
def test_sharded_matches_vmapped(rng, accelerated, halo):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    meas, _, _ = random_pose_graph(rng, num_poses=64, d=3, loop_closures=40)
    opts = MMOptions(accelerated=accelerated)
    ref = DPGOSolver(meas, num_nodes=8, opts=opts)
    shd = ShardedDPGOSolver(meas, num_nodes=8, opts=opts, halo=halo)
    st_r, hist_r = ref.run(12, record_every=3)
    st_s = shd.initialize()
    hist_s = []
    f, g = shd._metrics(st_s)
    hist_s.append((0, float(f), float(g)))
    for k in range(12):
        st_s = shd._step(st_s, jnp.asarray(k, jnp.int32))
        if (k + 1) % 3 == 0:
            f, g = shd._metrics(st_s)
            hist_s.append((k + 1, float(f), float(g)))
    hist_s = np.asarray(hist_s)
    np.testing.assert_allclose(hist_s[:, 1], hist_r[:, 1], rtol=1e-9)
    np.testing.assert_allclose(hist_s[:, 2], hist_r[:, 2], rtol=1e-6,
                               atol=1e-9)


def test_sharded_csail_converges():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    meas = read_g2o_file(dataset_path("CSAIL.g2o"))
    shd = ShardedDPGOSolver(meas, num_nodes=8, opts=MMOptions())
    st = shd.initialize()
    f0, _ = shd._metrics(st)
    for k in range(10):
        st = shd._step(st, jnp.asarray(k, jnp.int32))
    f1, g1 = shd._metrics(st)
    assert float(f1) < float(f0)
    assert np.isfinite(float(g1))


def test_sharded_scan_matches_per_step(rng):
    """run_steps (device scan) on the sharded solver == per-step stepping."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    meas, _, _ = random_pose_graph(rng, num_poses=64, d=3, loop_closures=40)
    shd = ShardedDPGOSolver(meas, num_nodes=8, opts=MMOptions())
    st = shd.initialize()
    st_a = st
    for k in range(8):
        st_a = shd._step(st_a, jnp.asarray(k, jnp.int32))
    st_b, k0 = shd.run_steps(st, jnp.zeros((), jnp.int32), 8)
    fa, _ = shd._metrics(st_a)
    fb, _ = shd._metrics(st_b)
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_halo_schedule_compaction(rng):
    """The boundary schedule reproduces exactly the full-gather halos."""
    from dpgo_tpu.parallel.spmd import build_halo_schedule
    meas, _, _ = random_pose_graph(rng, num_poses=60, d=3, loop_closures=30)
    ref = DPGOSolver(meas, num_nodes=6)
    mg = ref.mg
    sched = build_halo_schedule(mg)
    assert sched.B <= mg.n0_max
    st = ref.initialize()
    # Full-gather halo (driver.communicate semantics).
    th_full = st.Z.t[jnp.asarray(mg.halo_owner), jnp.asarray(mg.halo_lpose)]
    # Compacted: owner boundary buffers -> slot lookup.
    tb = st.Z.t[np.arange(mg.num_nodes)[:, None], sched.bnd]
    th_c = tb[jnp.asarray(mg.halo_owner), jnp.asarray(sched.halo_slot)]
    np.testing.assert_array_equal(np.asarray(th_full), np.asarray(th_c))


def test_sharded_star_matches_local(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from dpgo_tpu.driver import DPGOStarSolver
    from dpgo_tpu.parallel.spmd import ShardedDPGOStarSolver
    meas, _, _ = random_pose_graph(rng, num_poses=64, d=3, loop_closures=40)
    ref = DPGOStarSolver(meas, num_nodes=8, opts=MMOptions())
    shd = ShardedDPGOStarSolver(meas, num_nodes=8, opts=MMOptions())
    st_r, hist_r = ref.run(10, record_every=5)
    st_s = shd.initialize()
    hist_s = []
    f, g = shd._metrics(st_s)
    hist_s.append((0, float(f), float(g)))
    for k in range(10):
        st_s = shd._step(st_s, jnp.asarray(k, jnp.int32))
        if (k + 1) % 5 == 0:
            f, g = shd._metrics(st_s)
            hist_s.append((k + 1, float(f), float(g)))
    hist_s = np.asarray(hist_s)
    np.testing.assert_allclose(hist_s[:, 1], hist_r[:, 1], rtol=1e-9)


def test_sharded_polish_matches_local(rng):
    """polish() on the sharded solver (pose axis distributed over the mesh
    via _place_global) reaches the same objective as the local polish."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    meas, _, _ = random_pose_graph(rng, num_poses=64, d=3, loop_closures=40)
    ref = DPGOSolver(meas, num_nodes=8, opts=MMOptions())
    shd = ShardedDPGOSolver(meas, num_nodes=8, opts=MMOptions())
    st_r, _ = ref.run(5, record_every=5)
    st_s = shd.initialize()
    for k in range(5):
        st_s = shd._step(st_s, jnp.asarray(k, jnp.int32))
    st_r2, f_r = ref.polish(st_r, outer=8, tcg=50, coarse=True)
    st_s2, f_s = shd.polish(st_s, outer=8, tcg=50, coarse=True)
    np.testing.assert_allclose(f_s, f_r, rtol=1e-9)
    _, g_s = shd._metrics(st_s2)
    _, g_r = ref._metrics(st_r2)
    assert float(g_s) < 1e-6 or float(g_s) <= 2 * float(g_r)


def test_multihost_two_process_dcn():
    """2-process jax.distributed mini-cluster (the DCN code path without DCN
    hardware): both ranks run the sharded solver over a global mesh spanning
    processes and must agree bit-for-bit on the objective trajectory.
    (Exercises jax.distributed.initialize + shard_map over non-addressable
    devices — what a real multi-host deployment uses.)"""
    import os
    import socket
    import subprocess
    import sys

    # Pick a free port so parallel test runs don't collide.
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MHOST_PROCS="2", MHOST_DEVS="2",
               MHOST_PORT=str(port), PYTHONPATH=repo)
    env.pop("MHOST_RANK", None)
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "multihost_demo.py")],
        env=env, capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "multihost OK" in out.stdout, out.stdout


def test_sharded_f32_3d_steps_stay_finite():
    """The sharded float32 3-D deployment path (dense node models, TNT
    refinement, halo collectives under shard_map) runs and stays finite."""
    from jax.sharding import Mesh

    import __graft_entry__ as ge

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    n_dev = min(4, len(jax.devices()))
    meas = ge._synthetic_problem(num_poses=16 * n_dev, num_nodes=n_dev,
                                 seed=5)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("nodes",))
    s = ShardedDPGOSolver(meas, num_nodes=n_dev, mesh=mesh,
                          opts=MMOptions(accelerated=True),
                          dtype=jnp.float32)
    assert s.probs.dense
    st = s.initialize()
    st, _ = s.run_steps(st, jnp.zeros((), jnp.int32), 8)
    f, g = map(float, s._metrics(st))
    assert np.isfinite(f) and np.isfinite(g)
