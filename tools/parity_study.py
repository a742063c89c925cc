"""Iteration-count parity study: MM-PGO vs AMM-PGO# across the catalog.

For each certified dataset, run both schemes for a fixed budget and record
iterations (and relative objective trajectory milestones) to reach 1e-2 /
1e-3 / 1e-4 relative gap from the certified global optimum — the analog of
the T-RO paper's per-dataset convergence plots (the reference repo publishes
no numbers; our certified catalog is the ground truth). Writes
artifacts/parity_study.json and prints a markdown table.

Usage (CPU f64 by default; pass --f32 for the f32 solver):
    JAX_PLATFORMS=cpu PYTHONPATH=/root/repo python tools/parity_study.py
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATASETS = {
    # name: num_nodes (contiguous-block partition)
    "CSAIL.g2o": 4,
    "FR079.g2o": 4,
    "MITb.g2o": 4,
    "intel.g2o": 4,
    "M3500.g2o": 8,
    "manhattan.g2o": 8,
    "sphere2500.g2o": 8,
    "parking-garage.g2o": 4,
    "cubicle.g2o": 8,
}

GAPS = (1e-2, 1e-3, 1e-4)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--datasets", nargs="*", default=None)
    args = ap.parse_args()

    import jax
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cat = json.load(open(os.path.join(root, "artifacts",
                                      "certified_optima.json")))
    dtype = jnp.float32 if args.f32 else jnp.float64

    results = {}
    names = args.datasets or list(DATASETS)
    for name in names:
        path = os.path.join("/root/reference/dataset", name)
        if not os.path.exists(path) or name not in cat:
            print(f"skip {name} (missing dataset or certificate)")
            continue
        fstar = cat[name]["fxhat_2x"]
        meas = read_g2o_file(path)
        nodes = DATASETS.get(name, 4)
        row = {"certified_2x": fstar, "num_nodes": nodes}
        for scheme in ("mm", "amm"):
            solver = DPGOSolver(meas, num_nodes=nodes,
                                opts=MMOptions(accelerated=scheme == "amm"),
                                dtype=dtype)
            st = solver.initialize()
            k0 = jnp.zeros((), jnp.int32)
            st, _, (fh, _) = solver.run_steps_history(st, k0, args.iters)
            fh = np.asarray(fh, np.float64)
            gaps = fh / fstar - 1.0
            entry = {}
            for g in GAPS:
                hit = np.nonzero(gaps <= g)[0]
                entry[f"iters_to_{g:g}"] = int(hit[0]) + 1 if hit.size \
                    else None
            entry["final_gap"] = float(gaps[-1])
            row[scheme] = entry
            print(f"{name} {scheme}: {entry}", flush=True)
        results[name] = row

    out = os.path.join(root, "artifacts", "parity_study.json")
    with open(out, "w") as fh:
        json.dump({"iters_budget": args.iters,
                   "dtype": str(jnp.dtype(dtype)),
                   "results": results}, fh, indent=1)
    print(f"\nwrote {out}\n")

    hdr = "| dataset | nodes | " + " | ".join(
        f"MM→{g:g} / AMM→{g:g}" for g in GAPS) + " | final gap MM / AMM |"
    print(hdr)
    print("|" + "---|" * (len(GAPS) + 3))
    for name, row in results.items():
        cells = []
        for g in GAPS:
            m = row["mm"][f"iters_to_{g:g}"]
            a = row["amm"][f"iters_to_{g:g}"]
            cells.append(f"{m if m else '—'} / {a if a else '—'}")
        print(f"| {name} | {row['num_nodes']} | " + " | ".join(cells)
              + f" | {row['mm']['final_gap']:.1e} / "
                f"{row['amm']['final_gap']:.1e} |")


if __name__ == "__main__":
    main()
