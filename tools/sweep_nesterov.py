"""Sweep Nesterov/restart constants for iterations-to-certified-gap.

The reference exposes eta = [eta0, eta1] and the soft-restart budgets as
Options knobs (DPGO_types.h:100-140); the dist_pgo defaults target the
TNT-refined configuration. This sweeps them for the proximal-only f32
preset on sphere2500 8-node.

Usage: PYTHONPATH=. python tools/sweep_nesterov.py
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
TARGETS = [F_CERT_2X * (1 + 1e-4), F_CERT_2X * (1 + 1e-5)]
K = 150

meas = read_g2o_file("/root/reference/dataset/sphere2500.g2o")
NO_TNT = TNTParams(max_iterations=0)

CASES = {
    "default": {},
    "eta1=5e-2": dict(eta1=5e-2),
    "eta1=1e-1": dict(eta1=1e-1),
    "eta1=1e-2": dict(eta1=1e-2),
    "hits0=5": dict(max_soft_restart_hits0=5),
    "hits0=20": dict(max_soft_restart_hits0=20),
    "eta0=2e-3": dict(eta0=2e-3),
}

for name, kw in CASES.items():
    opts = MMOptions(accelerated=True, tnt=NO_TNT, **kw)
    solver = DPGOSolver(meas, num_nodes=8, opts=opts, dtype=jnp.float32)
    st = solver.initialize()
    k0 = jnp.zeros((), jnp.int32)
    out = solver.run_steps_history(st, k0, K)
    np.asarray(out[0].fobj)
    st = solver.initialize()
    t0 = time.perf_counter()
    _, _, (fhist, _) = solver.run_steps_history(st, k0, K)
    fhist = np.asarray(fhist)
    dt = time.perf_counter() - t0
    iters = []
    for tgt in TARGETS:
        hit = np.nonzero(fhist <= tgt)[0]
        iters.append(int(hit[0]) + 1 if hit.size else None)
    gap = fhist[-1] / F_CERT_2X - 1
    print(f"{name:12s}: it->1e-4 {iters[0]}  it->1e-5 {iters[1]}  "
          f"final_gap {gap:.2e}  ({K / dt:.0f} it/s)", flush=True)
