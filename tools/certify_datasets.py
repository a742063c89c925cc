"""Compute certified global optima for the benchmark datasets and write
artifacts/certified_optima.json (the test/bench ground-truth catalog).

Usage: PYTHONPATH=. python tools/certify_datasets.py
       [--datasets a.g2o b.g2o ...]
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = "/root/reference/dataset"
DEFAULT = ["CSAIL.g2o", "intel.g2o", "M3500.g2o", "manhattan.g2o",
           "FR079.g2o", "MITb.g2o", "sphere2500.g2o", "torus3D.g2o",
           "parking-garage.g2o", "cubicle.g2o", "smallGrid3D.g2o",
           "sphere_small.g2o", "tinyGrid3D.g2o"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", nargs="*", default=DEFAULT)
    ap.add_argument("--out", default="artifacts/certified_optima.json")
    args = ap.parse_args()

    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.sesync.staircase import sesync, SESyncOpts

    results = {}
    if os.path.exists(args.out):
        results = json.load(open(args.out))
    for name in args.datasets:
        path = os.path.join(DATA, name)
        if not os.path.exists(path):
            print(f"skip {name} (missing)")
            continue
        if name in results:
            print(f"skip {name} (already done)")
            continue
        try:
            t0 = time.time()
            meas = read_g2o_file(path)
            res = sesync(meas)
            status = res.status
            fxhat_2x = 2 * res.fxhat
            lam = res.lambda_min
            bound_2x = 2 * res.suboptimality_bound
            # Host-LM polish + direct certificate: the staircase's TNT
            # stalls on relative-decrease at large objective scales
            # (EigImprecision cases, e.g. sphere_bignoise), while the
            # exact-Newton polish reaches machine-precision stationarity
            # so the staged sparse certificate gives a clean verdict.
            # Only when needed: the staircase's own staged verification
            # already certified the healthy sets; the LM pass targets
            # EigImprecision stalls and loose rounding-gap bounds.
            need_lm = status != "GlobalOpt" or bound_2x > 0.01 * max(
                1.0, abs(fxhat_2x))
            try:
                if not need_lm:
                    raise StopIteration
                from dpgo_tpu.sesync.staircase import certify_solution
                from dpgo_tpu.solvers.host_lm import lm_polish
                lmres = lm_polish(meas, res.t, res.R)
                ok, lam_d, bound_d, fx_d = certify_solution(meas, lmres.R)
                improved = 2 * fx_d <= fxhat_2x \
                    + 1e-9 * max(1.0, abs(fxhat_2x))
                if ok and improved:
                    # Clean direct certificate of the polished estimate.
                    status = "GlobalOpt"
                    fxhat_2x = 2 * fx_d
                    lam = float(lam_d)
                    bound_2x = 2 * bound_d
                elif improved and status == "GlobalOpt":
                    # Relaxation certified globally but not tight at rank d
                    # (rounding gap, e.g. tinyGrid3D): keep the SDP
                    # certificate, adopt the better feasible value, and
                    # report the honest duality-gap bound
                    # f(xhat) - f* <= (f(xhat) - sdp_val)
                    #                + (nd/2) max(0, -lambda_min)
                    # (the slack term charges the staircase certificate's
                    # own tolerance, staircase.py finish()).
                    fxhat_2x = 2 * fx_d
                    bound_2x = (fxhat_2x - 2 * res.sdp_val
                                + meas.num_poses * meas.d
                                * max(0.0, -min(lam, 0.0)))
            except StopIteration:
                pass
            except Exception as e:
                print(f"  (lm polish skipped: {type(e).__name__} {e})",
                      flush=True)
            results[name] = {
                "status": status,
                "fxhat_2x": fxhat_2x,
                "sdp_2x": 2 * res.sdp_val,
                "lambda_min": lam,
                "suboptimality_bound_2x": bound_2x,
                "rank": res.rank,
                "poses": meas.num_poses,
                "edges": len(meas),
                "secs": round(time.time() - t0, 1),
            }
            print(name, results[name], flush=True)
        except Exception as e:
            print(f"{name} FAILED: {type(e).__name__} {e}", flush=True)
            results[name] = {"status": f"error: {type(e).__name__}"}
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
