"""Auxiliary subsystems: config loading, checkpointing, viz, SO(3) projection."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.synthetic import random_pose_graph


def test_config_roundtrip(tmp_path):
    from dpgo_tpu.config import load_config, save_config
    from dpgo_tpu.solvers.mm import MMOptions
    from dpgo_tpu.solvers.tnt import TNTParams
    opts = MMOptions(accelerated=False, eta0=1e-3,
                     tnt=TNTParams(max_iterations=7))
    p = str(tmp_path / "conf.yaml")
    save_config(p, opts, dataset="foo.g2o", num_nodes=4)
    opts2, extras = load_config(p)
    assert opts2.accelerated is False
    assert opts2.eta0 == 1e-3
    assert opts2.tnt.max_iterations == 7
    assert extras["dataset"] == "foo.g2o"
    assert extras["num_nodes"] == 4


def test_config_flat_tnt_keys(tmp_path):
    from dpgo_tpu.config import load_config
    p = str(tmp_path / "c.json")
    with open(p, "w") as fh:
        fh.write('{"accelerated": true, "kappa_fgr": 0.1, '
                 '"max_iterations": 5}')
    opts, extras = load_config(p)
    assert opts.tnt.kappa_fgr == 0.1
    assert opts.tnt.max_iterations == 5


def test_checkpoint_roundtrip(rng, tmp_path):
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions
    from dpgo_tpu.checkpoint import save_state, load_state
    meas, _, _ = random_pose_graph(rng, num_poses=24, d=2, loop_closures=10)
    solver = DPGOSolver(meas, num_nodes=2, opts=MMOptions())
    st = solver.initialize()
    for k in range(5):
        st = solver._step(st, jnp.asarray(k, jnp.int32))
    p = str(tmp_path / "ck.npz")
    save_state(p, st, 5)
    st2, step = load_state(p, st)
    assert step == 5
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Continue from the restored state: identical next step.
    n1 = solver._step(st, jnp.asarray(5, jnp.int32))
    n2 = solver._step(st2, jnp.asarray(5, jnp.int32))
    np.testing.assert_allclose(np.asarray(n1.fobj), np.asarray(n2.fobj))


def test_viz_writes_files(rng, tmp_path):
    from dpgo_tpu.viz import plot_trajectory, plot_convergence
    meas, t_true, _ = random_pose_graph(rng, num_poses=30, d=3)
    p1 = str(tmp_path / "traj.png")
    plot_trajectory(t_true, p1, edges=(meas.i, meas.j),
                    color_by_node=np.repeat([0, 1, 2], 10))
    assert os.path.getsize(p1) > 0
    hist = np.array([[0, 100.0, 10.0], [1, 50.0, 5.0], [2, 40.0, 1.0]])
    p2 = str(tmp_path / "conv.png")
    plot_convergence(hist, p2, f_star=39.0)
    assert os.path.getsize(p2) > 0


def test_viz_iterate_animation(rng, tmp_path):
    """SESyncVisualizer iterate-playback parity: a 3-frame GIF renders."""
    from dpgo_tpu.viz import animate_iterates
    meas, t_true, _ = random_pose_graph(rng, num_poses=20, d=2)
    frames = [t_true + 0.3 * rng.normal(size=t_true.shape),
              t_true + 0.1 * rng.normal(size=t_true.shape), t_true]
    p = str(tmp_path / "iterates.gif")
    animate_iterates(frames, p, edges=(meas.i, meas.j), fps=2)
    assert os.path.getsize(p) > 0


def test_ate_alignment(rng):
    from dpgo_tpu.metrics import ate, align_se, rotation_errors
    from dpgo_tpu.manifold import project_sod
    t = rng.normal(size=(50, 3)) * 3
    R = np.asarray(project_sod(jnp.asarray(rng.normal(size=(50, 3, 3)))))
    # Apply a random gauge transform; ATE must be ~0.
    G = np.asarray(project_sod(jnp.asarray(rng.normal(size=(3, 3)))))
    shift = rng.normal(size=3)
    t2 = t @ G.T + shift
    R2 = np.einsum("ab,nbc->nac", G, R)
    assert ate(t2, t) < 1e-10
    assert rotation_errors(R2, R, t2, t).max() < 1e-8
    # Perturbation produces a matching ATE scale.
    t3 = t2 + rng.normal(size=t.shape) * 0.1
    assert 0.05 < ate(t3, t) < 0.2


def test_cli_end_to_end(tmp_path, monkeypatch):
    """dist_pgo-equivalent CLI smoke test: runs, writes result files."""
    monkeypatch.chdir(tmp_path)
    from dpgo_tpu.cli import main
    from tests.conftest import DATASET_DIR
    ds = os.path.join(DATASET_DIR, "tinyGrid3D.g2o")
    if not os.path.exists(ds):
        pytest.skip("dataset unavailable")
    main(["--dataset", ds, "--num_nodes", "2", "--iters", "5",
          "--dist_init", "false", "--record_every", "5"])
    assert os.path.exists(tmp_path / "results_chordal_2_amm.txt")
    assert os.path.exists(tmp_path / "estimates_trivial.txt")
    rows = open(tmp_path / "results_chordal_2_amm.txt").read().splitlines()
    assert len(rows) == 2  # iter 0 + iter 5
