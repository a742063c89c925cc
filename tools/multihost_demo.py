"""Multi-process (multi-host) SPMD demonstration on CPU backends.

Launches N worker processes that form a jax.distributed cluster (the DCN
story without DCN hardware: each process owns 2 virtual CPU devices, the
global mesh spans all processes), runs the sharded AMM-PGO# solver over the
global `nodes` mesh axis, and checks every process agrees on the global
objective trajectory.

Usage:
    PYTHONPATH=/root/repo python tools/multihost_demo.py           # driver
    (the driver re-execs itself as workers with MHOST_RANK set)

This validates the exact code path a real multi-host deployment uses:
jax.distributed.initialize + a Mesh over non-addressable devices +
shard_map collectives for the halo exchange. On accelerator hosts only the
mesh construction changes (jax.devices() already spans hosts).
"""

import os
import subprocess
import sys

NUM_PROCS = int(os.environ.get("MHOST_PROCS", "4"))
DEVS_PER_PROC = int(os.environ.get("MHOST_DEVS", "2"))
PORT = int(os.environ.get("MHOST_PORT", "29517"))


def worker(rank: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVS_PER_PROC}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{PORT}",
                               num_processes=NUM_PROCS, process_id=rank)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dpgo_tpu.parallel.spmd import ShardedDPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ge", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)

    ndev = NUM_PROCS * DEVS_PER_PROC
    assert len(jax.devices()) == ndev, (rank, jax.devices())
    mesh = Mesh(np.asarray(jax.devices()), ("nodes",))

    meas = ge._synthetic_problem(num_poses=16 * ndev, num_nodes=ndev, seed=3)
    solver = ShardedDPGOSolver(meas, num_nodes=ndev, mesh=mesh,
                               opts=MMOptions(accelerated=True))

    # Multi-process jit cannot close over process-local jax.Arrays; keep the
    # jit constants as host numpy (identical on every process — jax shards
    # closure constants by value, which is exactly SPMD-consistent here).
    solver.probs = jax.tree.map(np.asarray, solver.probs)
    for name in ("halo_owner", "halo_lpose", "halo_slot", "bnd"):
        setattr(solver, name, np.asarray(getattr(solver, name)))

    st = solver.initialize()
    hist = []
    k0 = jnp.zeros((), jnp.int32)
    for _ in range(3):
        st, k0 = solver.run_steps(st, k0, 5)
        f, g = solver._metrics(st)
        hist.append(float(f))
    print(f"RANK{rank} HIST {' '.join(f'{h:.12g}' for h in hist)}",
          flush=True)
    jax.distributed.shutdown()


def main():
    if "MHOST_RANK" in os.environ:
        worker(int(os.environ["MHOST_RANK"]))
        return

    procs = []
    for r in range(NUM_PROCS):
        env = dict(os.environ, MHOST_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    hists = {}
    for r, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith(f"RANK{r} HIST"):
                hists[r] = line.split("HIST")[1].strip()
        if r not in hists:
            print(f"--- rank {r} output ---\n{out}")
            raise SystemExit(f"rank {r} produced no history")
    vals = set(hists.values())
    assert len(vals) == 1, f"processes disagree: {hists}"
    f_series = [float(x) for x in hists[0].split()]
    assert all(b <= a for a, b in zip(f_series, f_series[1:])), f_series
    print(f"multihost OK: {NUM_PROCS} processes x {DEVS_PER_PROC} devices, "
          f"objective {f_series[0]:.6g} -> {f_series[-1]:.6g}, "
          "all ranks agree")


if __name__ == "__main__":
    main()
