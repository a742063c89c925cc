"""Per-chunk step timing along the solver trajectory + CG-cap sensitivity.

Usage: PYTHONPATH=. python tools/profile_traj.py
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

from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.driver import DPGOSolver
from dpgo_tpu.solvers.mm import MMOptions
from dpgo_tpu.solvers.tnt import TNTParams

meas = read_g2o_file("/root/reference/dataset/sphere2500.g2o")

F_CERT_2X = 1687.005814


def profile(tag, opts):
    solver = DPGOSolver(meas, num_nodes=8, opts=opts, dtype=jnp.float32)
    st = solver.initialize()
    k0 = jnp.zeros((), jnp.int32)
    # compile
    stw, _ = solver.run_steps(st, k0, 10)
    jax.block_until_ready(stw.fobj)
    times = []
    for c in range(15):
        t0 = time.perf_counter()
        st, k0 = solver.run_steps(st, k0, 10)
        jax.block_until_ready(st.fobj)
        times.append((time.perf_counter() - t0) / 10 * 1000)
    f, g = solver._metrics(st)
    gap = float(f) / F_CERT_2X - 1.0
    print(f"[{tag}] ms/it per chunk:",
          " ".join(f"{t:.1f}" for t in times), flush=True)
    print(f"[{tag}] total {sum(times)*10/1000:.2f}s  "
          f"ips={150/(sum(times)*10/1000):.1f}  gap@150={gap:.2e}",
          flush=True)


profile("base (tCG=10000)", MMOptions(accelerated=True))
profile("tCG=50", MMOptions(accelerated=True,
                            tnt=TNTParams(max_tCG_iterations=50)))
profile("tCG=20", MMOptions(accelerated=True,
                            tnt=TNTParams(max_tCG_iterations=20)))
profile("tCG=10", MMOptions(accelerated=True,
                            tnt=TNTParams(max_tCG_iterations=10)))
