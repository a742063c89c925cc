"""Command-line driver: the reference dist_pgo equivalent.

Usage:
    python -m dpgo_tpu.cli --dataset path.g2o --num_nodes 4 [--iters 1000]
        [--dist_init true] [--loss trivial|huber|welsch] [--accelerated true]
        [--solver hash|star] [--pcm] [--save true] [--f32]
        [--checkpoint path.npz] [--checkpoint_every 100]

Writes results_chordal_<N>_<amm|mm>.txt with rows `iter time fobj grad`
(2x-scaled objective/gradient as in the reference, dist_pgo.cpp:492-553;
`main` also returns them as tuples) and gauge-normalized
estimates_<loss>.txt (first pose at origin/identity, dist_pgo.cpp:554-567).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Distributed PGO")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--num_nodes", type=int, required=True)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--dist_init", type=_bool, default=True)
    ap.add_argument("--loss", default="trivial",
                    choices=["trivial", "huber", "geman_mcclure", "welsch"])
    ap.add_argument("--loss_reg", type=float, default=0.25)
    ap.add_argument("--rescale", default="static",
                    choices=["static", "dynamic"],
                    help="robust-loss surrogate reweighting mode "
                         "(reference Rescale::{Static,Dynamic})")
    ap.add_argument("--accelerated", type=_bool, default=True)
    ap.add_argument("--preconditioner", default=None,
                    choices=["none", "jacobi", "dense"],
                    help="STPCG preconditioner (reference Preconditioner "
                         "enum, DPGO_types.h:35-40; 'dense' = the "
                         "RegularizedCholesky role). Default: auto")
    ap.add_argument("--accepted_delta", type=float, default=5e-4,
                    help="TNT refinement gate (reference "
                         "Options::accepted_delta)")
    ap.add_argument("--solver", default="hash", choices=["hash", "star"])
    ap.add_argument("--pcm", action="store_true",
                    help="PCM outlier rejection on inter edges before solving")
    ap.add_argument("--pcm_tolerance", type=float, default=0.2)
    ap.add_argument("--pcm_stream", type=int, default=0, metavar="BATCH",
                    help="feed inter edges through the incremental "
                         "PCMSolver pipeline in batches of BATCH (reference "
                         "PCMSolver::add_measurements flow); 0 = one-shot")
    ap.add_argument("--save", type=_bool, default=True)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--certify", action="store_true",
                    help="SE-Sync certification of the final estimate")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint_every", type=int, default=100)
    ap.add_argument("--record_every", type=int, default=1)
    ap.add_argument("--save_npz", default=None,
                    help="save the final estimate (t, R) to this .npz")
    ap.add_argument("--init_from", default=None,
                    help="warm-start from a saved .npz estimate instead of "
                         "chordal init (hybrid-precision recipe: bulk "
                         "iterations in f32, then an f64 run with "
                         "--init_from to polish past the f32 floor)")
    ap.add_argument("--polish", type=int, default=0, metavar="OUTER",
                    help="after the MM iterations, run OUTER global "
                         "Riemannian trust-region iterations on the coupled "
                         "problem (solvers/polish.py) — collapses the "
                         "long MM tail to the optimum superlinearly")
    ap.add_argument("--polish_tcg", type=int, default=500)
    ap.add_argument("--polish_coarse", type=_bool, default=True,
                    help="two-level block-rigid coarse preconditioner for "
                         "the polish (helps long corridor graphs)")
    ap.add_argument("--polish_levels", default="",
                    help="comma list of extra contiguous-segment coarse "
                         "levels for the polish preconditioner (e.g. "
                         "'64,256'; multilevel hierarchy for corridor "
                         "graphs with multiscale conditioning)")
    ap.add_argument("--lm_polish", action="store_true",
                    help="(trivial loss) finish with the host-side exact "
                         "sparse Newton polish (solvers/host_lm.py): "
                         "SuperLU-factored normal equations, conditioning-"
                         "immune — the recipe that certifies ais2klinik. "
                         "d=2: exact Newton (theta chart); d=3: Gauss-"
                         "Newton LM (SE(3) local chart)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu.solvers.mm import MMOptions

    dtype = jnp.float32 if args.f32 else jnp.float64
    if not args.f32:
        jax.config.update("jax_enable_x64", True)

    meas = read_g2o_file(args.dataset)
    loss = Loss(args.loss)
    # Validate flag combinations BEFORE the (possibly multi-minute) solve.
    if args.lm_polish and loss is not Loss.TRIVIAL:
        raise SystemExit("--lm_polish requires trivial loss")
    print(f"dataset: {args.dataset}  poses={meas.num_poses}  "
          f"edges={len(meas)}  d={meas.d}")

    if args.pcm:
        from dpgo_tpu.pcm import PCMOptions, pcm_filter
        from dpgo_tpu.sesync import (chordal_initialization,
                                     recover_translations_global)
        R0 = chordal_initialization(meas)
        t0 = recover_translations_global(meas, R0)
        if args.pcm_stream > 0:
            from dpgo_tpu.pcm import pcm_filter_incremental
            meas, keep = pcm_filter_incremental(
                meas, args.num_nodes, t0, R0,
                PCMOptions(tolerance=args.pcm_tolerance),
                batch=args.pcm_stream)
        else:
            meas, keep = pcm_filter(
                meas, args.num_nodes, t0, R0,
                PCMOptions(tolerance=args.pcm_tolerance))
        print(f"PCM kept {keep.sum()}/{len(keep)} edges")

    opts = MMOptions(accelerated=args.accelerated, rescale=args.rescale,
                     preconditioner=args.preconditioner,
                     accepted_delta=args.accepted_delta)
    cls = DPGOStarSolver if args.solver == "star" else DPGOSolver
    solver = cls(meas, num_nodes=args.num_nodes, opts=opts, loss=loss,
                 loss_reg=args.loss_reg, dtype=dtype)

    if args.init_from:
        warm = np.load(args.init_from)
        st = solver.initialize(t=warm["t"], R=warm["R"])
    else:
        st = solver.initialize(dist_init=args.dist_init)
    start_iter = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        from dpgo_tpu.checkpoint import load_state
        st, start_iter = load_state(args.checkpoint, st, solver=solver)
        print(f"resumed from {args.checkpoint} at iteration {start_iter}")

    f, g = solver._metrics(st)
    rows = [(start_iter, 0.0, float(f), float(g))]
    print(f"{start_iter}: {float(f):.20g} {float(g):.20g}")

    # Device-side chunked stepping: the loop between record/checkpoint
    # boundaries runs in ONE dispatch (see DPGOSolver.run_steps).
    elapsed = 0.0
    k = start_iter
    k_dev = jnp.asarray(start_iter, jnp.int32)
    while k < args.iters:
        nxt = min(args.iters,
                  (k // args.record_every + 1) * args.record_every)
        if args.checkpoint:
            nxt = min(nxt, (k // args.checkpoint_every + 1)
                      * args.checkpoint_every)
        t_start = time.perf_counter()
        st, k_dev = solver.run_steps(st, k_dev, nxt - k)
        jax.block_until_ready(st.Z.t)
        elapsed += time.perf_counter() - t_start
        k = nxt
        if k % args.record_every == 0 or k == args.iters:
            f, g = solver._metrics(st)
            rows.append((k, elapsed, float(f), float(g)))
            print(f"{k}: {float(f):.20g} {float(g):.20g}")
        if args.checkpoint and k % args.checkpoint_every == 0:
            from dpgo_tpu.checkpoint import save_state
            save_state(args.checkpoint, st, k, gauge_c=solver._c)

    if args.polish > 0:
        t_start = time.perf_counter()
        segs = tuple(int(x) for x in args.polish_levels.split(",")
                     if x.strip())
        st, _ = solver.polish(st, outer=args.polish, tcg=args.polish_tcg,
                              coarse=args.polish_coarse,
                              coarse_segments=segs)
        elapsed += time.perf_counter() - t_start
        f, g = solver._metrics(st)
        rows.append((k, elapsed, float(f), float(g)))
        print(f"polish({args.polish}): {float(f):.20g} {float(g):.20g}")

    if args.lm_polish:
        from dpgo_tpu.solvers.host_lm import lm_polish
        t_g, R_g = map(np.asarray, solver.gather_global(st))
        t_start = time.perf_counter()
        res = lm_polish(meas, t_g, R_g)
        elapsed += time.perf_counter() - t_start
        st = solver.initialize(res.t, res.R)
        f, g = solver._metrics(st)
        # With --f32 the solver metrics evaluate in f32, whose ~1e-4-relative
        # noise floor can mask the f64 polish improvement entirely; report
        # the exact host f64 objective of the polished estimate alongside.
        from dpgo_tpu.solvers.host_lm import host_objective_2f
        f64_2f = host_objective_2f(meas, res.t, res.R)
        rows.append((k, elapsed, float(f), float(g)))
        print(f"lm_polish({res.iters} it): {float(f):.20g} "
              f"{float(g):.20g} (exact f64 2f = {f64_2f:.12f})")

    print("---------------------------------------")
    print(f"final objective: {rows[-1][2]}")
    print(f"final gradient: {rows[-1][3]}")
    print(f"time: {elapsed / args.num_nodes} s/node.")

    t_glob, R_glob = map(np.asarray, solver.gather_global(st))

    if args.save_npz:
        np.savez(args.save_npz, t=t_glob, R=R_glob)
        print(f"saved estimate to {args.save_npz}")

    if args.certify:
        from dpgo_tpu.sesync.staircase import certify_solution
        ok, lam, bound, fx = certify_solution(meas, R_glob)
        print(f"certification: {'GLOBAL OPT' if ok else 'uncertified'} "
              f"lambda_min={lam:.3e} suboptimality_bound={bound:.3e}")

    if args.save:
        name = f"results_chordal_{args.num_nodes}_" \
               f"{'amm' if args.accelerated else 'mm'}.txt"
        with open(name, "w") as fh:
            for r in rows:
                fh.write(f"{int(r[0])} {r[1]:.16g} {r[2]:.16g} "
                         f"{r[3]:.16g}\n")
        # Gauge-normalize: first pose at origin / identity.
        t_n = t_glob - t_glob[0]
        R0 = R_glob[0]
        t_n = t_n @ R0
        R_n = np.einsum("ba,nbc->nac", R0, R_glob)
        with open(f"estimates_{args.loss}.txt", "w") as fh:
            for p in range(meas.num_poses):
                fh.write(" ".join(f"{v:.16g}" for v in t_n[p]) + "\n")
            for p in range(meas.num_poses):
                for r in range(meas.d):
                    fh.write(" ".join(f"{v:.16g}"
                                      for v in R_n[p, r]) + "\n")
        print(f"wrote {name} and estimates_{args.loss}.txt")
    return rows


if __name__ == "__main__":
    from dpgo_tpu.utils import enable_compile_cache
    enable_compile_cache()
    main()
