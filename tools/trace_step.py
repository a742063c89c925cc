"""Capture a jax.profiler trace of solver steps (TensorBoard-viewable).

Usage: PYTHONPATH=. python tools/trace_step.py \
       [--dataset .../sphere2500.g2o] [--nodes 8] [--out chiprun_out/trace]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset",
                    default="/root/reference/dataset/sphere2500.g2o")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/trace")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import jax
    from dpgo_tpu.utils import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    dtype = jnp.float64 if args.f64 else jnp.float32
    meas = read_g2o_file(args.dataset)
    solver = DPGOSolver(meas, num_nodes=args.nodes, opts=MMOptions(),
                        dtype=dtype)
    st = solver.initialize()
    st = solver._step(st, jnp.asarray(0, jnp.int32))  # compile
    jax.block_until_ready(st.fobj)

    with jax.profiler.trace(args.out):
        for k in range(1, args.steps + 1):
            st = solver._step(st, jnp.asarray(k, jnp.int32))
        jax.block_until_ready(st.fobj)
    print(f"trace written to {args.out} (view with tensorboard --logdir)")


if __name__ == "__main__":
    main()
