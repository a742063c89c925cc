"""Run the BASELINE.json configuration suite and write BASELINE_RESULTS.md.

Usage (CPU f64):
    PYTHONPATH=. python tools/run_baselines.py

Covers the five BASELINE.json configs (substituting smallGrid3D and the
synthetic artifacts/grid3D_synth.g2o — tools/make_grid3d.py — for the
stripped grid3D/rim blobs) plus certification of the final estimates.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = "/root/reference/dataset"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))




def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--out", default="BASELINE_RESULTS.md")
    args = ap.parse_args()
    it = args.iters

    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from dpgo_tpu.utils import enable_compile_cache
    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.solvers.mm import MMOptions

    dtype = jnp.float64

    def run_config(name, dataset, nodes, iters, accelerated=True,
                   solver="hash", loss=Loss.TRIVIAL, pcm=False,
                   dist_init=False, certify=False, polish=0,
                   dynamic=False):
        path = dataset if os.path.isabs(dataset) \
            else os.path.join(DATA, dataset)
        meas = read_g2o_file(path)
        if pcm:
            from dpgo_tpu.pcm import PCMOptions, pcm_filter
            from dpgo_tpu.sesync import (chordal_initialization,
                                         recover_translations_global)
            R0 = chordal_initialization(meas)
            t0 = recover_translations_global(meas, R0)
            meas, keep = pcm_filter(meas, nodes, t0, R0,
                                    PCMOptions(tolerance=1.0))
            pcm_note = f"PCM kept {keep.sum()}/{len(keep)}"
        else:
            pcm_note = ""
        cls = DPGOStarSolver if solver == "star" else DPGOSolver
        s = cls(meas, num_nodes=nodes,
                opts=MMOptions(accelerated=accelerated,
                               rescale="dynamic" if dynamic else "static"),
                loss=loss, loss_reg=0.25, dtype=dtype)
        st = s.initialize(dist_init=dist_init) if solver == "hash" \
            else s.initialize()
        f0, g0 = s._metrics(st)
        k0 = jnp.zeros((), jnp.int32)
        # Warmup dispatch: compile the stepping scan, the metrics jit and
        # (when used) the polish BEFORE the timed phase, so `secs` measures
        # the solve, not compile-cache load.
        st_w, _ = s.run_steps(st, k0, iters)
        fw, _ = s._metrics(st_w)
        float(fw)  # device_get sync
        if polish:
            s.polish(st_w, outer=polish, tcg=500, coarse=True)
        st = s.initialize(dist_init=dist_init) if solver == "hash" \
            else s.initialize()
        # Device-side chunked stepping (one dispatch per chunk).
        t_start = time.time()
        st, _ = s.run_steps(st, k0, iters)
        f1, g1 = s._metrics(st)
        float(f1)  # device_get sync
        if polish:
            # The real CLI recipe (cli.py --polish: tcg=500, coarse
            # multilevel preconditioner) — the budget that reaches 1.6e-7
            # on city10000 — not an under-budgeted stand-in.
            st, _ = s.polish(st, outer=polish, tcg=500, coarse=True)
            f1, g1 = s._metrics(st)
            float(f1)
        dt = time.time() - t_start
        cert = ""
        if certify and loss is Loss.TRIVIAL:
            t_g, R_g = map(np.asarray, s.gather_global(st))
            from dpgo_tpu.sesync.staircase import certify_solution
            ok, lam, bound, fx = certify_solution(meas, R_g,
                                                  dtype=jnp.float64)
            cert = f"lam_min={lam:.2e} {'CERT' if ok else 'uncert'}"
        # Relative gap to the certified global optimum (when the dataset is
        # in the catalog and the loss is trivial, so objectives compare).
        # The gap is computed from an EXACT host f64 evaluation of the
        # final estimate, independent of the solver's own metrics.
        gap = ""
        if loss is Loss.TRIVIAL and not pcm:
            import json
            cat = os.path.join(REPO, "artifacts", "certified_optima.json")
            try:
                from dpgo_tpu.solvers.host_lm import host_objective_2f
                opt = json.load(open(cat))[os.path.basename(dataset)]
                t_g, R_g = map(np.asarray, s.gather_global(st))
                f64_2f = host_objective_2f(meas, t_g, R_g)
                gap = f"{f64_2f / opt['fxhat_2x'] - 1.0:.1e}"
            except Exception:
                pass
        row = (name, os.path.basename(dataset), nodes, iters, float(f0),
               float(f1), float(g1), dt, gap,
               " ".join(x for x in (pcm_note, cert) if x))
        print(row, flush=True)
        return row

    rows = []

    def flush_rows():
        hdr = "CPU float64"
        with open(args.out, "w") as fh:
            fh.write("# BASELINE configuration results\n\n")
            fh.write(f"({hdr}, {it} iterations per config; objective "
                     "convention 2*fobj as in the reference driver)\n\n")
            fh.write("| config | dataset | nodes | iters | 2f init | "
                     "2f final | 2|grad| | secs | rel gap to 2f* | notes |\n"
                     "|---|---|---|---|---|---|---|---|---|---|\n")
            for r in rows:
                fh.write(f"| {r[0]} | {r[1]} | {r[2]} | {r[3]} | "
                         f"{r[4]:.4f} | {r[5]:.4f} | {r[6]:.2e} | "
                         f"{r[7]:.1f} | {r[8]} | {r[9]} |\n")
            fh.write(
                "\nrel gap = 2f_final / 2f* - 1 against the certified "
                "global optimum (artifacts/certified_optima.json). "
                "Certification notes charge the estimate's stationarity "
                "defect (residual-honest), so fixed-iteration estimates "
                "report a negative lam_min of that order rather than a "
                "fake 0.\n")

    def add(row):
        rows.append(row)
        flush_rows()

    grid_synth = os.path.join(REPO, "artifacts", "grid3D_synth.g2o")
    rim_synth = os.path.join(REPO, "artifacts", "rim_synth.g2o")

    add(run_config("cfg1 MM single-node", "CSAIL.g2o", 1, it,
                   accelerated=False, certify=True))
    add(run_config("cfg2 AMM* chordal", "intel.g2o", 4, it, solver="star"))
    add(run_config("cfg2 AMM* chordal", "M3500.g2o", 4, it, solver="star"))
    add(run_config("cfg3 AMM# 8-node", "sphere2500.g2o", 8, it,
                   certify=True))
    add(run_config("cfg3 AMM# 8-node", "torus3D.g2o", 8, it))
    add(run_config("cfg4 Huber+PCM", "city10000.g2o", 16, it,
                   loss=Loss.HUBER, pcm=True))
    add(run_config("cfg4 Huber+dynamic", "city10000.g2o", 16, it,
                   loss=Loss.HUBER, dynamic=True))
    add(run_config("cfg4 Welsch", "smallGrid3D.g2o", 4, it,
                   loss=Loss.WELSCH))
    # Geman-McClure rows (the 4th evaluate_E kernel, DPGOProblem.cpp:
    # 634-681): static at city10000 scale + dynamic rescale — no robust
    # kernel is bench-unexercised.
    add(run_config("cfg4 GemanMcClure", "city10000.g2o", 16, it,
                   loss=Loss.GEMAN_MCCLURE))
    add(run_config("cfg4 GM+dynamic", "city10000.g2o", 16, it,
                   loss=Loss.GEMAN_MCCLURE, dynamic=True))
    if os.path.exists(grid_synth):
        add(run_config("cfg4 Huber (synthetic grid3D)", grid_synth, 8, it,
                       loss=Loss.HUBER))
    add(run_config("cfg5 16-node + cert", "parking-garage.g2o", 4, it,
                   certify=True))
    add(run_config("cfg5 16-node + cert", "cubicle.g2o", 16, it,
                   certify=True))
    if os.path.exists(rim_synth):
        add(run_config("cfg5 16-node (synthetic rim)", rim_synth, 16, it))
    add(run_config("cfg5 dist-init", "MITb.g2o", 4, it, dist_init=True))
    # Global second-order polish rows (solvers/polish.py): the MM bulk phase
    # plus a handful of coupled trust-region iterations — the long-tail
    # collapse; secs include the polish.
    add(run_config("sphere2500 +polish", "sphere2500.g2o", 8, it,
                   certify=True, polish=10))
    add(run_config("MITb +polish", "MITb.g2o", 4, it, polish=10))
    add(run_config("city10000 +polish", "city10000.g2o", 16, it, polish=10))
    # cfg2 datasets: the AMM* bulk rows above stop short of the certified
    # optimum (1e-3/1e-4 gaps at 300 iters); these rows show the in-tree
    # fix (the global polish) closing them.
    add(run_config("intel +polish", "intel.g2o", 4, it, polish=10))
    add(run_config("M3500 +polish", "M3500.g2o", 4, it, polish=10))

    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
