"""Differential timing of the solver step (maintained profiling tool).

Every timing here runs a scan of K iterations in ONE dispatch, starts from
a fresh initialize() and waits with block_until_ready. Component costs are
obtained differentially by ablating options (TNT off, history on/off, ...).

Usage: PYTHONPATH=. python tools/profile_step.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

from dpgo_tpu.utils import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp

from dpgo_tpu.driver import DPGOSolver
from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.solvers.mm import MMOptions
from dpgo_tpu.solvers.tnt import TNTParams

DATASET = os.environ.get("PROFILE_DATASET",
                         "/root/reference/dataset/sphere2500.g2o")
NODES = int(os.environ.get("PROFILE_NODES", "8"))
K = int(os.environ.get("PROFILE_ITERS", "150"))

meas = read_g2o_file(DATASET)


def time_solver(name, opts, history=False):
    solver = DPGOSolver(meas, num_nodes=NODES, opts=opts, dtype=jnp.float32)
    st = solver.initialize()
    k0 = jnp.zeros((), jnp.int32)
    run = solver.run_steps_history if history else solver.run_steps
    out = run(st, k0, K)           # compile + warm
    jax.block_until_ready(out[0].fobj)
    st = solver.initialize()
    t0 = time.perf_counter()
    out = run(st, k0, K)
    jax.block_until_ready(out[0].fobj)
    dt = time.perf_counter() - t0
    f, g = solver._metrics(out[0])
    print(f"{name}: {dt / K * 1000:.2f} ms/it ({K / dt:.1f} it/s)  "
          f"2f={float(f):.4f}", flush=True)
    return dt / K


full = time_solver("full step (scan)", MMOptions(accelerated=True))
hist = time_solver("full step + history", MMOptions(accelerated=True),
                   history=True)
no_tnt = time_solver(
    "step, TNT off",
    MMOptions(accelerated=True, tnt=TNTParams(max_iterations=0)))
mm_only = time_solver("plain MM step", MMOptions(accelerated=False))
cg50 = time_solver(
    "step, max_tCG=50",
    MMOptions(accelerated=True, tnt=TNTParams(max_tCG_iterations=50)))

print(f"\nTNT share        : {1000 * (full - no_tnt):.2f} ms/it")
print(f"history overhead : {1000 * (hist - full):.2f} ms/it")
