"""Benchmark harness: AMM-PGO# iterations per second on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}.

Headline: the reference-default refined preset — accelerated AMM-PGO# with
the TNT refinement gate at its dist_pgo defaults (accepted_delta=5e-4, TNT
10/1, dist_pgo.cpp:103-120) — on sphere2500, 8 nodes, f32, measured in the
pure-throughput phase (one device-side scan dispatch, no history
recording). Extras: the proximal-only preset (TNT off) with its global
polish tail, city10000 16-node, rim_synth 10,240-pose 16-node (d=3 dense
path) and rim_synth_100k (the segment path). Rows whose dataset is absent
are reported as such; any other failure stops the run.

Usage: python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = "/root/reference/dataset"


def main():
    import jax
    import jax.numpy as jnp

    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.solvers.mm import MMOptions
    from dpgo_tpu.solvers.tnt import TNTParams
    from dpgo_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dtype = jnp.float32
    k0 = jnp.zeros((), jnp.int32)

    def throughput(solver, n):
        """Iterations/s of an n-step scan (one dispatch), after a warm-up
        run of the same shape; returns (it/s, final state)."""
        st, _ = solver.run_steps(solver.initialize(), k0, n)
        jax.block_until_ready(st)
        st = solver.initialize()
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        st, _ = solver.run_steps(st, k0, n)
        jax.block_until_ready(st)
        return n / (time.perf_counter() - t0), st

    def secs_to_gap(solver, n, f_cert_2x, gap):
        """(secs, iters) to 2f <= f_cert_2x (1 + gap), prorated from the
        wall time of one n-step history scan (None when not reached)."""
        st, _, hist = solver.run_steps_history(solver.initialize(), k0, n)
        jax.block_until_ready(hist)
        st = solver.initialize()
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        _, _, (fhist, _) = solver.run_steps_history(st, k0, n)
        fhist = np.asarray(fhist)
        dt = time.perf_counter() - t0
        hit = np.nonzero(fhist <= f_cert_2x * (1.0 + gap))[0]
        if not hit.size:
            return None, None
        return dt * (int(hit[0]) + 1) / n, int(hit[0]) + 1

    extra = {"dtype": "float32", "gpu": smi,
             "xla_flags": os.environ.get("XLA_FLAGS", "")}
    value = None

    # ------------------------------------------------- headline: refined
    sphere = os.path.join(DATA, "sphere2500.g2o")
    if os.path.exists(sphere):
        meas = read_g2o_file(sphere)
        # Certified global optimum of sphere2500 (2*f*), from this
        # framework's own SE-Sync staircase + certification (GlobalOpt).
        f_cert = 1687.005814
        s = DPGOSolver(meas, num_nodes=8, opts=MMOptions(accelerated=True),
                       dtype=dtype)
        value, st = throughput(s, 600)
        f1, g1 = map(float, s._metrics(st))
        secs, iters = secs_to_gap(s, 150, f_cert, 1e-4)
        extra.update({
            "preset": "refined reference-default (TNT 10/1, "
                      "accepted_delta=5e-4)",
            "certified_opt_2x": f_cert,
            "fobj_final_2x": f1,
            "grad_final_2x": g1,
            "rel_gap_final": f1 / f_cert - 1.0,
            "secs_to_certified_opt_1e-4": secs,
            "iters_to_certified_opt_1e-4": iters,
        })

        s_px = DPGOSolver(meas, num_nodes=8,
                          opts=MMOptions(accelerated=True,
                                         tnt=TNTParams(max_iterations=0)),
                          dtype=dtype)
        ips_px, st_px = throughput(s_px, 600)
        secs_px, it_px = secs_to_gap(s_px, 150, f_cert, 1e-4)
        s_px.polish(st_px, outer=6, tcg=100)  # compile
        t0 = time.perf_counter()
        _, f_pol = s_px.polish(st_px, outer=6, tcg=100)
        extra.update({
            "proximal_only_iters_per_sec": ips_px,
            "proximal_only_secs_to_1e-4": secs_px,
            "proximal_only_iters_to_1e-4": it_px,
            "polish_secs": time.perf_counter() - t0,
            "polish_rel_gap": f_pol / f_cert - 1.0,
        })
    else:
        extra["sphere2500"] = "dataset missing"

    # ---------------------------------------------- city10000 16-node
    city = os.path.join(DATA, "city10000.g2o")
    if os.path.exists(city):
        s_c = DPGOSolver(read_g2o_file(city), num_nodes=16,
                         opts=MMOptions(accelerated=True), dtype=dtype)
        ips_c, st_c = throughput(s_c, 300)
        extra["city10000_16node"] = {
            "iters_per_sec": ips_c,
            "fobj_2x_300it": float(s_c._metrics(st_c)[0]),
            "certified_opt_2x": 638.624619,
        }
    else:
        extra["city10000_16node"] = "dataset missing"

    # ------------------------- rim_synth 10,240 poses, 16 nodes, d = 3
    rim = os.path.join(REPO, "artifacts", "rim_synth.g2o")
    s_r = DPGOSolver(read_g2o_file(rim), num_nodes=16,
                     opts=MMOptions(accelerated=True), dtype=dtype)
    ips_r, st_r = throughput(s_r, 150)
    extra["rim_synth_10240_16node"] = {
        "iters_per_sec": ips_r,
        "fobj_2x_150it": float(s_r._metrics(st_r)[0]),
    }

    # --------------- rim_synth_100k — the SEGMENT-path regime
    # 102,400 poses / 16 nodes = 6,400-pose blocks, far past dense_limit:
    # the reference's CHOLMOD-any-size regime (DPGOProblem.cpp:93-124),
    # served here by segment-Schwarz CG translation solves. Dataset
    # generated on demand (deterministic, tools/make_rim.py).
    rim100k = os.path.join(REPO, "artifacts", "rim_synth_100k.g2o")
    if not os.path.exists(rim100k):
        subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "make_rim.py"),
             "--rows", "32", "--cols", "64", "--floors", "50",
             "--out", rim100k], check=True, timeout=1200)
    meas_k = read_g2o_file(rim100k)
    s_k = DPGOSolver(meas_k, num_nodes=16,
                     opts=MMOptions(accelerated=True,
                                    tnt=TNTParams(max_iterations=0)),
                     dtype=dtype)
    ips_k, st_k = throughput(s_k, 100)
    f_k, g_k = map(float, s_k._metrics(st_k))
    extra["rim_synth_100k_16node_segment"] = {
        "poses": int(meas_k.num_poses),
        "poses_per_node": int(meas_k.num_poses) // 16,
        "iters_per_sec": ips_k,
        "segment_path": bool(s_k.probs.seg),
        "fobj_2x_100it": f_k,
        "grad_2x_100it": g_k,
    }

    print(json.dumps({
        "metric": "sphere2500_8node_amm_iters_per_sec",
        "value": value,
        "unit": "iter/s",
        "device": device,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
