"""Ablation: TNT refinement settings vs time-to-certified-target.

For each option set, runs run_steps_history (one dispatch, fresh buffers)
and reports it/s, iters-to-target, secs-to-target, final relative gap.

Usage: PYTHONPATH=. python tools/ablate_tnt.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

from dpgo_tpu.utils import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

from dpgo_tpu.driver import DPGOSolver
from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.solvers.mm import MMOptions
from dpgo_tpu.solvers.tnt import TNTParams

F_CERT_2X = 1687.005814
TARGET = F_CERT_2X * (1.0 + 1e-4)
K = int(os.environ.get("ABLATE_ITERS", "150"))

meas = read_g2o_file("/root/reference/dataset/sphere2500.g2o")

CASES = {
    "default": MMOptions(accelerated=True),
    "tnt_off": MMOptions(accelerated=True,
                         tnt=TNTParams(max_iterations=0)),
    "tnt_max1": MMOptions(accelerated=True,
                          tnt=TNTParams(max_iterations=1)),
    "tcg25": MMOptions(accelerated=True,
                       tnt=TNTParams(max_tCG_iterations=25)),
    "delta5e-3": MMOptions(accelerated=True, accepted_delta=5e-3),
    "delta5e-2": MMOptions(accelerated=True, accepted_delta=5e-2),
}

for name, opts in CASES.items():
    solver = DPGOSolver(meas, num_nodes=8, opts=opts, dtype=jnp.float32)
    st = solver.initialize()
    k0 = jnp.zeros((), jnp.int32)
    out = solver.run_steps_history(st, k0, K)
    np.asarray(out[0].fobj)
    st = solver.initialize()
    t0 = time.perf_counter()
    stf, _, (fhist, _) = solver.run_steps_history(st, k0, K)
    fhist = np.asarray(fhist)
    dt = time.perf_counter() - t0
    hit = np.nonzero(fhist <= TARGET)[0]
    iters_to = int(hit[0]) + 1 if hit.size else None
    secs_to = dt * iters_to / K if iters_to else None
    gap = float(fhist[-1]) / F_CERT_2X - 1.0
    print(f"{name:12s}: {K / dt:6.1f} it/s  iters->1e-4: {iters_to}  "
          f"secs->1e-4: {None if secs_to is None else round(secs_to, 3)}  "
          f"final_gap: {gap:.2e}", flush=True)
