"""Certify a saved pose estimate in CPU float64, with optional f64 polish.

The hybrid-precision recipe, automated: f32 estimates carry an f32-level
stationarity defect, and the residual-honest certificate charges that defect
— so certify in an f64 CPU process, optionally after a short f64 AMM polish
that removes the f32 noise (30 iterations suffice on the benchmark graphs).

Prints ONE JSON line. Usage:

  JAX_PLATFORMS=cpu python tools/certify_estimate.py \
      --dataset /root/reference/dataset/sphere2500.g2o --npz est.npz \
      --num_nodes 8 --polish_iters 30
"""

import argparse
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--npz", required=True, help=".npz with t [P,d], R [P,d,d]")
    ap.add_argument("--num_nodes", type=int, default=8)
    ap.add_argument("--polish_iters", type=int, default=30)
    ap.add_argument("--min_eig_tol", type=float, default=1e-5)
    ap.add_argument("--pre_polish", type=int, default=15, metavar="OUTER",
                    help="global coupled trust-region iterations before the "
                         "staircase warm start (0 disables)")
    ap.add_argument("--pre_polish_tcg", type=int, default=200)
    ap.add_argument("--pre_polish_levels", default="",
                    help="extra contiguous-segment coarse levels for the "
                         "polish preconditioner (e.g. '64,256')")
    ap.add_argument("--lm", type=lambda s: s.lower() != "false",
                    default=True,
                    help="host exact-Newton LM polish + direct staged "
                         "certificate (the default recipe); 'false' falls "
                         "back to the polish + staircase-warm-start route")
    args = ap.parse_args()

    import jax.numpy as jnp
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.sesync.staircase import SESyncOpts, certify_solution, sesync

    meas = read_g2o_file(args.dataset)
    data = np.load(args.npz)
    t, R = data["t"], data["R"]

    if args.lm:
        # Round-4 default recipe: host exact-Newton LM polish (reaches
        # machine-precision stationarity regardless of conditioning,
        # solvers/host_lm.py) + the staged direct certificate — faster
        # and more reliable than the polish + staircase-warm-start
        # route below (kept under --lm false).
        from dpgo_tpu.solvers.host_lm import lm_polish
        from dpgo_tpu.objective import EdgeData, evaluate_f
        edges = EdgeData.from_measurements(meas, dtype=jnp.float64)
        raw_2f = 2 * float(evaluate_f(edges, jnp.asarray(t, jnp.float64),
                                      jnp.asarray(R, jnp.float64)))
        lmres = lm_polish(meas, t, R)
        ok, lam, bound, fx = certify_solution(
            meas, lmres.R, min_eig_tol=args.min_eig_tol, dtype=jnp.float64)
        print(json.dumps({
            "certified": bool(ok), "lambda_min": float(lam),
            "suboptimality_bound_2x": 2 * float(bound),
            "fxhat_2x": 2 * float(fx),
            "raw_estimate_2f": raw_2f,
            "raw_rel_gap": raw_2f / (2 * fx) - 1.0,
            "polish": "host-lm",
        }))
        return

    if args.pre_polish > 0:
        # Global coupled trust-region polish (solvers/polish.py) in f64
        # first: collapses the estimate's stationarity defect far faster
        # than the staircase's block-Jacobi-preconditioned TNT would, so
        # the warm-started staircase mostly just verifies.
        from dpgo_tpu.driver import DPGOSolver
        from dpgo_tpu.solvers.mm import MMOptions
        from dpgo_tpu.solvers.tnt import TNTParams
        s = DPGOSolver(meas, num_nodes=args.num_nodes,
                       opts=MMOptions(tnt=TNTParams(max_iterations=0)),
                       dtype=jnp.float64)
        st = s.initialize(t=t, R=R)
        segs = tuple(int(x) for x in args.pre_polish_levels.split(",")
                     if x.strip())
        st, _ = s.polish(st, outer=args.pre_polish, tcg=args.pre_polish_tcg,
                         coarse=True, coarse_segments=segs)
        t, R = map(np.asarray, s.gather_global(st))

    if args.polish_iters > 0:
        # The residual-honest certificate charges the estimate's
        # stationarity defect, so an AMM tail (slow near the optimum) never
        # gets tight enough: polish by warm-starting the SE-Sync staircase
        # (f64 TNT to 1e-6 gradient) from the estimate's rotations, then
        # the staircase's own certificate applies.
        n, d = meas.num_poses, meas.d
        Y0 = np.swapaxes(np.asarray(R, np.float64), 1, 2).reshape(n * d, d)
        res = sesync(meas, SESyncOpts(min_eig_tol=args.min_eig_tol),
                     Y0=Y0)
        from dpgo_tpu.objective import EdgeData, evaluate_f
        edges = EdgeData.from_measurements(meas, dtype=jnp.float64)
        raw_2f = 2 * float(evaluate_f(edges, jnp.asarray(t, jnp.float64),
                                      jnp.asarray(R, jnp.float64)))
        print(json.dumps({
            "certified": res.status == "GlobalOpt",
            "lambda_min": float(res.lambda_min),
            "suboptimality_bound_2x": 2 * float(res.suboptimality_bound),
            "fxhat_2x": 2 * float(res.fxhat),
            "raw_estimate_2f": raw_2f,
            "raw_rel_gap": raw_2f / (2 * res.fxhat) - 1.0,
            "polish": "sesync-staircase-warmstart",
        }))
        return

    ok, lam, bound, fx = certify_solution(
        meas, R, min_eig_tol=args.min_eig_tol, dtype=jnp.float64)
    print(json.dumps({
        "certified": bool(ok), "lambda_min": float(lam),
        "suboptimality_bound_2x": 2 * float(bound), "fxhat_2x": 2 * float(fx),
        "polish": None,
    }))


if __name__ == "__main__":
    main()
