"""Smoke test of the solver on an NVIDIA GPU: the quickest proof that the
system still starts on the card and computes the right answers there.

    python chip_smoke.py           # one GPU: phases 0-4
    python chip_smoke.py --multi   # four GPUs: the sharded solver only

Phases (one card):
  0. device report; exits non-zero unless JAX's first device is a GPU;
  1. SO(3) projection at the solver's widths (10,240 rotations, and 16
     nodes of 640) against a numpy float64 SVD projection: the solver's
     entry point, the plain jnp body and the Triton kernel;
  2. the trust-region CG (tnt.stpcg) of one rim_synth node in float32 (whose
     Hessian matvec may run in TF32) against the same call in float64;
  3. the main path, `python -m dpgo_tpu.cli` on rim_synth (10,240 poses,
     16 robots, 300 iterations) in float32 and float64, checked against the
     CPU float64 objective of the same configuration;
  4. Huber + dynamic rescale on grid3D_synth, with the problem arrays
     embedded as jit constants and passed as jit arguments, both checked
     against the CPU float64 objective.
With --multi only phase 5 runs: rim_synth on a 4-card mesh (4 robots per
card) for each halo strategy, against the vmapped solver on card 0.

The last line of standard output is one JSON object with the device as JAX
reports it; it is printed only when every check passed.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RIM = os.path.join(HERE, "artifacts", "rim_synth.g2o")
GRID = os.path.join(HERE, "artifacts", "grid3D_synth.g2o")

# CPU float64 objectives (2f) of phases 3 and 4 on this tree, computed with
# JAX_PLATFORMS=cpu and x64 enabled by
#   phase 3: python -m dpgo_tpu.cli --dataset artifacts/rim_synth.g2o
#            --num_nodes 16 --iters 300 --dist_init false --save_npz est.npz
#            then solvers.host_lm.host_objective_2f(meas, t, R) of est.npz
#   phase 4: python -c "import chip_smoke as c; c.cpu_reference_phase4()"
RIM_300_F64_2F = 16169.87817186544
GRID_HUBER_DYN_150_F64_2F = 3990.995399241455

failures = []


def check(name, ok, detail=""):
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        failures.append(name)


def rel(a, b):
    return abs(a - b) / abs(b)


def device_report(jax):
    """Phase 0. Returns the device dict of the contract's last line."""
    devs = jax.devices()
    d0 = devs[0]
    print(f"jax {jax.__version__}: platform={d0.platform} "
          f"kind={d0.device_kind!r} count={len(devs)}", flush=True)
    if d0.platform != "gpu":
        print(f"no GPU found (JAX platform {d0.platform!r}); "
              "chip_smoke runs only on the card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    return ({"platform": d0.platform, "kind": d0.device_kind,
             "count": len(devs)}, smi)


def cache_entries(path):
    return len(os.listdir(path)) if os.path.isdir(path) else 0


def so3_inputs(rng, n, neg_share):
    """n matrices U diag(s) V^T with singular values in [1, 2] x [0.5, 0.8]
    x [0.1, 0.3] (so every projection is well conditioned: its error is at
    most ~1/(s2 - s3) <= 5 times the rounding of the entries), and det < 0
    for a `neg_share` fraction."""
    def rot(k):
        q, r = np.linalg.qr(rng.normal(size=(k, 3, 3)))
        q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
        q[np.linalg.det(q) < 0, :, 0] *= -1
        return q
    s = np.stack([rng.uniform(1.0, 2.0, n), rng.uniform(0.5, 0.8, n),
                  rng.uniform(0.1, 0.3, n)], axis=1)
    s[rng.random(n) < neg_share, 2] *= -1
    return np.einsum("nab,nb,ncb->nac", rot(n), s, rot(n))


def so3_reference(A):
    """Frobenius-closest rotation by float64 SVD (numpy, on the host)."""
    U, _, Vt = np.linalg.svd(A)
    D = np.ones(A.shape[:-1])
    D[:, -1] = np.linalg.det(U @ Vt)
    return np.einsum("nab,nb,nbc->nac", U, D, Vt)


def phase1_projection(jax, n=10240, seed=0):
    import jax.numpy as jnp
    from dpgo_tpu.manifold import project_sod
    from dpgo_tpu.ops.so3 import polar_so3
    from dpgo_tpu.ops.so3_triton import polar_so3_triton

    print("phase 1: SO(3) projection parity", flush=True)
    rng = np.random.default_rng(seed)
    A = so3_inputs(rng, n, 0.2)
    R_ref = so3_reference(A)
    print(f"  {n} matrices, {int((np.linalg.det(A) < 0).sum())} with det<0",
          flush=True)
    # Tolerances: ~100 float32 / ~5e3 float64 roundings of O(1) entries,
    # times the conditioning bound of so3_inputs.
    fns = {"project_sod": project_sod, "polar_so3 (jnp)": polar_so3,
           "polar_so3_triton": polar_so3_triton}
    for dtype, tol in ((jnp.float32, 1e-5), (jnp.float64, 1e-12)):
        # The solver's two widths: the global retract and the per-node one.
        for shape in ((n, 3, 3), (16, n // 16, 3, 3)):
            x = jnp.asarray(A.reshape(shape), dtype)
            for name, fn in fns.items():
                f = jax.jit(fn)
                R = np.asarray(f(x))
                err = float(np.abs(R.reshape(n, 3, 3) - R_ref).max())
                same = bool((np.asarray(f(x)) == R).all())
                check(f"{name} {jnp.dtype(dtype).name} {shape}",
                      err <= tol and same,
                      f"max|R - R_svd| = {err:.3e} (tol {tol:g}), "
                      f"second call bitwise equal: {same}")


def tnt_entry(p, t, R, g_t, g_R):
    """TNT-entry quantities of one dense node model (tall Q storage)."""
    Q = p.to_tall(R)
    nabla = p.reduced_grad_tall(t, Q, p.to_tall(g_R))
    grad = p.proj_tall(Q, nabla)
    return Q, nabla, grad, p.precondition_tall(Q, grad)


def phase2_cg(jax, meas, node=0, warm=20):
    import jax.numpy as jnp
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.tnt import TNTParams, stpcg

    print("phase 2: trust-region CG, float32 (TF32 matvecs) vs float64",
          flush=True)
    s = DPGOSolver(meas, num_nodes=16, dtype=jnp.float64)
    # Past the chordal start, where the first CG step would already leave
    # the unit trust region; here CG runs several interior iterations.
    st, _ = s.run_steps(s.initialize(), jnp.zeros((), jnp.int32), warm)
    p64 = jax.tree.map(lambda x: x[node], s.probs)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                       if jnp.issubdtype(x.dtype, jnp.floating) else x, p64)
    params = TNTParams()

    # The TNT-entry quantities are formed once in float64 and rounded to
    # each dtype, so the comparison sees only what runs inside stpcg.
    entry = tnt_entry(p64, st.Z.t[node], st.Z.R[node], st.g_t[node],
                      st.g_R[node])

    def run(p, dtype):
        Q, nabla, grad, pgrad = (jnp.asarray(x, dtype) for x in entry)
        h, Hh, nrm, k = jax.jit(lambda: stpcg(
            grad, lambda v: p.hessian_vp_tall(Q, nabla, v),
            lambda v: p.precondition_tall(Q, v),
            jnp.asarray(params.Delta0, dtype), params, v0=pgrad))()
        dm = -jnp.sum(grad * h) - 0.5 * jnp.sum(h * Hh)
        return np.asarray(h, np.float64), float(nrm), int(k), float(dm)

    h32, n32, k32, m32 = run(p32, jnp.float32)
    h64, n64, k64, m64 = run(p64, jnp.float64)
    n0 = int(p64.pose_mask.sum())
    print(f"  node {node}: {n0} poses, d={p64.d}; CG iterations f32 {k32} "
          f"/ f64 {k64}; model decrease f32 {m32:.9g} / f64 {m64:.9g}",
          flush=True)
    check("CG iteration count", k32 == k64, f"{k32} vs {k64}")
    dh = float(np.linalg.norm(h32 - h64) / np.linalg.norm(h64))
    check("step h", dh <= 2e-3, f"|h32 - h64| / |h64| = {dh:.3e} (tol 2e-3)")
    check("step M-norm", rel(n32, n64) <= 2e-3,
          f"{n32:.9g} vs {n64:.9g} (rel {rel(n32, n64):.3e}, tol 2e-3)")


def phase3_main_path(jax, meas, smi, iters=300):
    from dpgo_tpu import cli
    from dpgo_tpu.solvers.host_lm import host_objective_2f

    args = ["--dataset", RIM, "--num_nodes", "16", "--iters", str(iters),
            "--dist_init", "false", "--save", "false"]
    for f32, tol in ((True, 1e-5), (False, 1e-7)):
        name = "float32" if f32 else "float64"
        print(f"phase 3: python -m dpgo_tpu.cli on rim_synth, {name}",
              flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            npz = os.path.join(tmp, "est.npz")
            t0 = time.perf_counter()
            rows = cli.main(args + ["--save_npz", npz]
                            + (["--f32"] if f32 else []))
            wall = time.perf_counter() - t0
            est = np.load(npz)
            f2 = host_objective_2f(meas, est["t"], est["R"])
        rows = np.asarray(rows, np.float64)
        check(f"{name} rows finite", bool(np.isfinite(rows).all()),
              f"{len(rows)} rows, last iteration {int(rows[-1, 0])}")
        # AMM-PGO#'s restarts keep each node's surrogate monotone, not the
        # global objective: the float64 rows of this run rise by up to
        # 5.6e-7 relative between iterations 160 and 300, on the CPU as on
        # the GPU. The float32 rows add the evaluation noise of a sum over
        # 12,927 edges. A diverging run rises by far more.
        rise = float(np.max(np.diff(rows[:, 2]) / rows[:-1, 2]))
        rise_tol = 1e-5 if f32 else 1e-6
        check(f"{name} objective decreases", rise <= rise_tol
              and rows[-1, 2] < rows[0, 2],
              f"largest relative rise {rise:.3e} (tol {rise_tol:g})")
        check(f"{name} exact f64 objective of the estimate",
              rel(f2, RIM_300_F64_2F) <= tol,
              f"2f = {f2:.10f} vs CPU f64 {RIM_300_F64_2F:.10f} "
              f"(rel {rel(f2, RIM_300_F64_2F):.3e}, tol {tol:g})")
        # The CLI dispatches one step per recorded row; its clock includes
        # the first dispatch, which compiles.
        steady = (iters - 1) / (rows[-1, 1] - rows[1, 1])
        print(f"  info: {steady:.1f} iterations/s over CLI iterations 2-"
              f"{iters}; first iteration (compiling) {rows[1, 1]:.2f} s; "
              f"{wall:.1f} s wall in all, on {smi}", flush=True)


def embed_vs_argument(meas, dtype, iters=150):
    """Final 2f (float64 evaluation) of grid3D Huber + dynamic rescale,
    8 nodes, for each jit form {embedded: value}."""
    import jax
    import jax.numpy as jnp
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.objective import EdgeData, evaluate_f
    from dpgo_tpu.solvers.mm import MMOptions

    s = DPGOSolver(meas, num_nodes=8,
                   opts=MMOptions(accelerated=True, rescale="dynamic"),
                   loss=Loss.HUBER, loss_reg=0.25, dtype=dtype)
    edges = EdgeData.from_measurements(meas, node_of=s.part.node_of,
                                       dtype=jnp.float64)
    out = {}
    for embed in (True, False):
        s._embed_consts = embed
        s._make_jits()
        st, _ = s.run_steps(s.initialize(), jnp.zeros((), jnp.int32), iters)
        t, R = s.gather_global(st)
        out[embed] = 2.0 * float(jax.jit(evaluate_f, static_argnums=(3, 4))(
            edges, jnp.asarray(t, jnp.float64), jnp.asarray(R, jnp.float64),
            Loss.HUBER, 0.25))
    return out


def cpu_reference_phase4():
    """Prints the CPU float64 reference of phase 4 (run with
    JAX_PLATFORMS=cpu)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from dpgo_tpu.io.g2o import read_g2o_file
    out = embed_vs_argument(read_g2o_file(GRID), jnp.float64)
    print(f"{jax.devices()[0].platform} float64: {out}")


def phase4_embed(jax, meas):
    import jax.numpy as jnp

    print("phase 4: Huber + dynamic rescale, embedded vs argument constants",
          flush=True)
    out = embed_vs_argument(meas, jnp.float32)
    for embed, f2 in out.items():
        form = "embedded" if embed else "argument"
        check(f"{form} constants", rel(f2, GRID_HUBER_DYN_150_F64_2F) <= 1e-3,
              f"2f = {f2:.8f} vs CPU f64 {GRID_HUBER_DYN_150_F64_2F:.8f} "
              f"(rel {rel(f2, GRID_HUBER_DYN_150_F64_2F):.3e}, tol 1e-3)")
    print(f"  embedded vs argument: rel {rel(out[True], out[False]):.3e}",
          flush=True)


def phase5_multi(jax, meas, n_dev=4, steps=20):
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.parallel.spmd import ShardedDPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    devs = jax.devices()
    if len(devs) < n_dev:
        print(f"--multi needs {n_dev} devices, JAX found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    mesh = Mesh(np.asarray(devs[:n_dev]), ("nodes",))
    k0 = jnp.zeros((), jnp.int32)
    nodes = 16
    sim = DPGOSolver(meas, num_nodes=nodes, dtype=jnp.float32)
    _, _, (f_sim, _) = sim.run_steps_history(sim.initialize(), k0, steps)
    f_sim = np.asarray(f_sim, np.float64)
    print(f"phase 5: {nodes} robots on {n_dev} cards; vmapped on "
          f"{devs[0]}: 2f after {steps} steps = {f_sim[-1]:.6f}", flush=True)
    for halo in ("boundary", "gather", "ring"):
        s = ShardedDPGOSolver(meas, num_nodes=nodes, mesh=mesh, halo=halo,
                              dtype=jnp.float32)
        st = s.initialize()
        st, _, (f_shd, _) = s.run_steps_history(st, k0, steps)
        f_shd = np.asarray(f_shd, np.float64)
        d = float(np.max(np.abs(f_shd - f_sim) / np.abs(f_sim)))
        placed = sorted({dv.id for dv in st.Z.R.sharding.device_set})
        print(f"  {halo}: Z.R {st.Z.R.shape} sharding {st.Z.R.sharding}",
              flush=True)
        check(f"{halo} on {n_dev} devices", len(placed) == n_dev,
              f"device ids {placed}")
        check(f"{halo} {steps}-step trajectory", d < 5e-5,
              f"max rel diff vs vmapped {d:.3e} (tol 5e-5)")
    for dv in devs[:n_dev]:
        ms = dv.memory_stats() or {}
        print(f"  {dv}: bytes_in_use={ms.get('bytes_in_use')} "
              f"peak_bytes_in_use={ms.get('peak_bytes_in_use')}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    device, smi = device_report(jax)

    sys.path.insert(0, HERE)
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.utils import enable_compile_cache
    cache = enable_compile_cache()
    print(f"compile cache: {cache} ({cache_entries(cache)} entries at start)",
          flush=True)

    rim = read_g2o_file(RIM)
    if args.multi:
        phase5_multi(jax, rim)
    else:
        phase1_projection(jax)
        phase2_cg(jax, rim)
        phase3_main_path(jax, rim, smi)
        phase4_embed(jax, read_g2o_file(GRID))
    if failures:
        print(f"FAILED: {', '.join(failures)}", file=sys.stderr)
        sys.exit(1)
    print(f"compile cache: {cache_entries(cache)} entries at end", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
