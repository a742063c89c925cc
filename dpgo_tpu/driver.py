"""End-to-end distributed PGO driver (the dist_pgo equivalent).

Single-process simulation mode: the node axis is vmapped; communication is a
pure gather on the stacked node states (the reference's in-process
communicate(), DPGO_utils.h:397-453). One solver iteration =
iterate -> communicate -> update inside a single jit (dist_pgo.cpp:492-531).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_tpu.graph import build_multigraph
from dpgo_tpu.io.g2o import Measurements
from dpgo_tpu.losses import Loss
from dpgo_tpu.objective import EdgeData, evaluate_f, grad_norm
from dpgo_tpu.problem import NodeProblem, NodeState, build_node_problems
from dpgo_tpu.sesync import chordal_initialization, recover_translations_global
from dpgo_tpu.solvers import mm as mm_mod
from dpgo_tpu.solvers import star as star_mod
from dpgo_tpu.solvers.mm import MMOptions, MMState, init_state


def communicate(st: MMState, halo_owner, halo_lpose, halo_dc=None) -> MMState:
    """Refresh every node's halo from the owners' current own state.

    `halo_dc` [N, n1_max, d] re-expresses the owner's locally-centered
    translations in the reader's frame (local gauge centering, below)."""
    th = st.Z.t[halo_owner, halo_lpose]
    if halo_dc is not None:
        th = th + halo_dc
    Rh = st.Z.R[halo_owner, halo_lpose]
    Z = NodeState(t=st.Z.t, R=st.Z.R, th=th, Rh=Rh)
    return st._replace(Z=Z)


class DPGOSolver:
    """Distributed PGO on one device: vmapped node axis, jitted step."""

    def __init__(self, meas: Measurements, num_nodes: int,
                 opts: MMOptions | None = None,
                 loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0,
                 dtype=jnp.float64, dense_limit: int = 4096,
                 segment_limit: int = 2048, seg_size: int = 128):
        self.meas = meas
        self.num_nodes = num_nodes
        self.opts = opts or MMOptions()
        self.dtype = dtype
        self.part, self.nodes, self.mg = build_multigraph(meas, num_nodes)
        precon_cond = self.opts.precon_cond
        if precon_cond is None:
            precon_cond = 1e6 if dtype == jnp.float64 else 1e5
        # dense_limit: per-node blocks with n0*d above it use the edge-wise
        # (matrix-free) operator path instead of materialized dense
        # operators. segment_limit: blocks with more poses than it use the
        # SEGMENT path (segment-Schwarz CG translation solves + coupled
        # segment-preconditioned TNT) — no [n0, n0] arrays at any point.
        self.probs = build_node_problems(
            self.mg, xi=self.opts.regularizer, loss=loss, loss_reg=loss_reg,
            precon_cond=precon_cond, dense_limit=dense_limit,
            segment_limit=segment_limit, seg_size=seg_size, dtype=dtype)
        self.edges = EdgeData.from_measurements(
            meas, node_of=self.part.node_of, dtype=dtype)
        self.loss = loss
        self.loss_reg = loss_reg
        self.halo_owner = jnp.asarray(self.mg.halo_owner)
        self.halo_lpose = jnp.asarray(self.mg.halo_lpose)
        self.node_of = jnp.asarray(self.part.node_of)
        self.local_of = jnp.asarray(self.part.local_of)
        # Local gauge centering: store each node's translations relative to
        # its own block centroid (fixed at first initialize). Every cost and
        # solver quantity is difference-based, so the math is unchanged
        # (only the xi = 1e-11 tie-breaker sees the shift) while f32
        # cancellation error in t_i - t_j drops from graph-diameter to
        # block-diameter scale — the big-2-D-graph (city10000) f32 floor.
        # None = auto: on for f32, off for f64 (which doesn't need it).
        lg = getattr(self.opts, "local_gauge", None)
        self.local_gauge = (dtype == jnp.float32) if lg is None else lg
        self._c = None  # [N, d] block centroids, set at first initialize
        self.halo_dc = None
        # Small problems EMBED the problem arrays as jit closure constants,
        # which XLA may fold and pre-lay-out; large problems pass them as
        # jit ARGUMENTS, because embedded constants are stored inside the
        # compiled program (and its persistent-cache entry) and are
        # serialized with it. The 80 MB threshold is inherited, not
        # measured on the GPU (choosing one jit form is an open item).
        probs_bytes = sum(x.nbytes for x in jax.tree.leaves(self.probs))
        self._embed_consts = probs_bytes < 80 * 2**20
        self._make_jits()
        self._first_update = jax.jit(
            partial(mm_mod.update_state, opts=self.opts,
                    k=jnp.zeros((), jnp.int32), first=True))
        self._metrics = jax.jit(self._metrics_impl)

    def _make_jits(self):
        if self._embed_consts:
            self._step_jit = jax.jit(
                lambda st, k: self._step_impl(self.probs, st, k))
            self._multi_step = jax.jit(
                lambda st, k0, num_steps: self._multi_step_impl(
                    self.probs, st, k0, num_steps),
                static_argnames=("num_steps",))
            self._multi_step_history = jax.jit(
                lambda st, k0, num_steps: self._multi_step_history_impl(
                    self.probs, st, k0, num_steps),
                static_argnames=("num_steps",))
        else:
            self._step_jit = jax.jit(self._step_impl)
            self._multi_step = jax.jit(self._multi_step_impl,
                                       static_argnames=("num_steps",))
            self._multi_step_history = jax.jit(
                self._multi_step_history_impl,
                static_argnames=("num_steps",))

    def _step(self, st: MMState, k):
        if self._embed_consts:
            return self._step_jit(st, k)
        return self._step_jit(self.probs, st, k)

    # ----------------------------------------------------------- init

    def _set_gauge(self, t: np.ndarray) -> None:
        """Fix the per-node gauge centroids from a global t (first call
        only: the jitted step captures halo_dc at trace time, so the frame
        must stay fixed for the solver's lifetime)."""
        if not self.local_gauge or self._c is not None:
            return
        mg = self.mg
        c = np.zeros((mg.num_nodes, mg.d))
        for a in range(mg.num_nodes):
            s, n0 = int(mg.start[a]), int(mg.n0[a])
            c[a] = np.asarray(t[s:s + n0], np.float64).mean(axis=0)
        self.set_gauge(c)

    def set_gauge(self, c: np.ndarray) -> None:
        """Install explicit gauge centroids (checkpoint resume path)."""
        # Round to the working precision so host/device adds are exact.
        c = np.asarray(c, np.dtype(self.dtype)).astype(np.float64)
        self._c = c
        self.halo_dc = jnp.asarray(
            c[self.mg.halo_owner] - c[:, None, :], self.dtype)

    def pack_global(self, t: np.ndarray, R: np.ndarray) -> NodeState:
        """Distribute a global (t [P,d], R [P,d,d]) into padded node states
        (halo filled by communicate), applying the local gauge offsets."""
        mg = self.mg
        t = np.asarray(t, np.float64)
        tn = np.zeros((mg.num_nodes, mg.n0_max, mg.d))
        Rn = np.tile(np.eye(mg.d), (mg.num_nodes, mg.n0_max, 1, 1))
        for a in range(mg.num_nodes):
            n0 = int(mg.n0[a])
            s = int(mg.start[a])
            tn[a, :n0] = t[s:s + n0]
            Rn[a, :n0] = R[s:s + n0]
        gidx = mg.start[mg.halo_owner] + mg.halo_lpose
        th = t[gidx]
        if self._c is not None:
            tn = tn - self._c[:, None, :]
            th = th - self._c[:, None, :]
        return NodeState(
            t=jnp.asarray(tn, self.dtype), R=jnp.asarray(Rn, self.dtype),
            th=jnp.asarray(th, self.dtype),
            Rh=jnp.asarray(R[gidx], self.dtype))

    def gather_global(self, st: MMState):
        """Assemble the global (t, R) from per-node own blocks (undoing the
        local gauge offsets)."""
        t = st.Z.t[self.node_of, self.local_of]
        if self._c is not None:
            t = t + jnp.asarray(self._c, self.dtype)[self.node_of]
        R = st.Z.R[self.node_of, self.local_of]
        return t, R

    def initialize(self, t: np.ndarray | None = None,
                   R: np.ndarray | None = None,
                   dist_init: bool = False) -> MMState:
        """Initialization: centralized chordal by default, or the 4-stage
        distributed DChordal pipeline with dist_init=True
        (dist_pgo.cpp:144-444)."""
        if R is None and dist_init:
            from dpgo_tpu.chordal import distributed_chordal_init
            t, R = distributed_chordal_init(self.meas, self.num_nodes,
                                            dtype=self.dtype)
        if R is None:
            R = chordal_initialization(self.meas)
        if t is None:
            t = recover_translations_global(self.meas, R)
        # Center the translation gauge: pure gauge freedom, and it minimizes
        # |t| magnitudes (the chordal init anchors pose 0 at the origin, so
        # coordinates grow with graph diameter — costly in f32, where
        # catastrophic cancellation in t_i - t_j scales with |t|).
        t = t - np.asarray(t).mean(axis=0, keepdims=True)
        self._set_gauge(t)
        st = init_state(self.probs, self.pack_global(t, R), self.opts)
        st = communicate(st, self.halo_owner, self.halo_lpose, self.halo_dc)
        st = st._replace(Z_prev=st.Z)
        return self._first_update(self.probs, st)

    # ----------------------------------------------------------- stepping

    def _step_impl(self, probs: NodeProblem, st: MMState, k):
        probs_w = mm_mod.reweighted_problems(probs, st, self.opts)
        scheme = mm_mod.resolve_scheme(self.opts)
        if scheme == "amm":
            st = mm_mod.iterate_amm(probs_w, st, self.opts, k)
        elif scheme == "aa":
            st = mm_mod.iterate_aa(probs_w, st, self.opts, k)
        else:
            st = mm_mod.iterate_mm(probs_w, st, self.opts, k)
        st = communicate(st, self.halo_owner, self.halo_lpose, self.halo_dc)
        # Z_prev (stamped inside iterate) is the previous anchor including the
        # halo of the previous round's communicate — exactly the reference's
        # X[iter-1] as consumed by DPGOHash::update.
        return mm_mod.update_state(probs, st, self.opts, k + 1,
                                   first=False)

    def _multi_step_impl(self, probs, st: MMState, k0, num_steps: int):
        """`num_steps` solver iterations in ONE dispatch (device-side scan).

        The per-step API costs a host->device round trip per iteration.
        Returns (state, k0 + num_steps) so the iteration counter never
        leaves the device between chunks.
        """
        def body(carry, i):
            return self._step_impl(probs, carry, k0 + i), None

        st, _ = jax.lax.scan(body, st, jnp.arange(num_steps, dtype=jnp.int32))
        return st, k0 + num_steps

    def run_steps(self, st: MMState, k0, num_steps: int):
        """Public chunked-stepping entry point (k0 a device int32 scalar)."""
        if self._embed_consts:
            return self._multi_step(st, k0, num_steps=num_steps)
        return self._multi_step(self.probs, st, k0, num_steps=num_steps)

    def _multi_step_history_impl(self, probs, st: MMState, k0,
                                 num_steps: int):
        """Scan `num_steps` iterations recording (2f, 2|grad|) per step on
        device (no host polling — the reference driver's per-iteration metric
        series, dist_pgo.cpp:523-530).

        The per-step values come free from the state update_state already
        computed: node objectives sum to the exact global objective (inter
        edges are split half/half between endpoints) and each block's
        gradient of the GLOBAL objective is computed exactly once per node,
        so the global gradient norm is the rms over nodes."""
        def body(carry, i):
            stn = self._step_impl(probs, carry, k0 + i)
            f = 2.0 * jnp.sum(stn.fobj)
            g = 2.0 * jnp.sqrt(jnp.sum(stn.gradFnorm * stn.gradFnorm))
            return stn, (f, g)

        st, hist = jax.lax.scan(body, st,
                                jnp.arange(num_steps, dtype=jnp.int32))
        return st, k0 + num_steps, hist

    def run_steps_history(self, st: MMState, k0, num_steps: int):
        if self._embed_consts:
            return self._multi_step_history(st, k0, num_steps=num_steps)
        return self._multi_step_history(self.probs, st, k0,
                                        num_steps=num_steps)

    def _metrics_impl(self, st: MMState):
        t, R = self.gather_global(st)
        f = evaluate_f(self.edges, t, R, self.loss, self.loss_reg)
        g = grad_norm(self.edges, t, R, self.loss, self.loss_reg)
        return 2.0 * f, 2.0 * g

    def _node_block_precondition(self, probs: NodeProblem):
        """Node-block surrogate preconditioner for the global polish: per
        node, the exact split-inverse mG00 solve for translations and the
        dense regularized mG11 inverse (the STPCG RegularizedCholesky role)
        for rotations. Block-diagonal over nodes -> SPD; collapses intra-node
        conditioning exactly, leaving CG only the inter-node coupling."""
        from dpgo_tpu.manifold import proj_tangent
        mg = self.mg
        P = self.meas.num_poses
        gidx = jnp.asarray(np.minimum(
            np.asarray(mg.start)[:, None] + np.arange(mg.n0_max)[None, :],
            P - 1), jnp.int32)
        mask = jnp.asarray(np.arange(mg.n0_max)[None, :]
                           < np.asarray(mg.n0)[:, None])

        def precondition(x, v):
            vt, vR = v
            tn = jnp.where(mask[..., None], vt[gidx], 0.0)
            Rn = jnp.where(mask[..., None, None], vR[gidx], 0.0)

            def per_node(p, tn_a, Rn_a):
                if p.dense:
                    Rp = p.from_tall(jnp.matmul(p.precon_dense,
                                                p.to_tall(Rn_a)))
                elif p.seg:
                    Rp = p.precondition_R_seg(Rn_a)
                else:
                    Rp = jnp.einsum("pab,pbc->pac", Rn_a, p.precon_inv)
                tp = p.solve_mG00(tn_a, t_anchor=jnp.zeros_like(tn_a))
                return tp, Rp

            tp, Rp = jax.vmap(per_node)(probs, tn, Rn)
            out_t = tp[self.node_of, self.local_of]
            out_R = Rp[self.node_of, self.local_of]
            return out_t, proj_tangent(x[1], out_R)

        return precondition

    def polish(self, st: MMState, outer: int = 20, tcg: int = 500,
               node_precon: bool = True, coarse: bool = False,
               coarse_segments: tuple = ()):
        """Global second-order tail polish: gather the full pose state, run
        Riemannian TNT on the coupled problem (solvers/polish.py — one halo
        exchange per CG iteration, cheap on-device), and re-anchor the solver
        state at the result. Returns (state, 2*f_value).

        `coarse=True` adds the block-rigid coarse correction to the
        preconditioner (cross-node lever-arm conditioning); non-empty
        `coarse_segments` (e.g. (64, 256)) adds finer contiguous-segment
        rigid levels on top — the additive multilevel hierarchy for
        corridor-style multiscale conditioning (ais2klinik); see
        polish.multilevel_rigid_preconditioner. Passing coarse_segments
        implies the coarse path (and requires the node preconditioner as the
        hierarchy's base level)."""
        from dpgo_tpu.solvers import polish as polish_mod
        coarse_segments = tuple(coarse_segments)
        if coarse_segments and not coarse:
            coarse = True  # segments imply the multilevel hierarchy
        if coarse and not node_precon:
            raise ValueError(
                "polish(coarse=True / coarse_segments=...) needs the "
                "node-block preconditioner as the hierarchy's base level; "
                "pass node_precon=True")
        key = (outer, tcg, node_precon, coarse, coarse_segments)
        if getattr(self, "_polish_jits", None) is None:
            self._polish_jits = {}
        if key not in self._polish_jits:
            params = polish_mod.polish_params(outer=outer, tcg=tcg)

            # probs is a jit ARGUMENT so the (possibly ~100 MB) problem
            # arrays are never embedded in the compiled program.
            def impl(probs, t, R):
                precon = (self._node_block_precondition(probs)
                          if node_precon else None)
                if coarse and precon is not None:
                    model0 = polish_mod.global_tnt_model(
                        self.edges, self.loss, self.loss_reg,
                        num_poses=t.shape[0], precondition=precon)
                    _, nabla = model0.grad_and_nabla((t, R))
                    P = t.shape[0]
                    levels = [(self.node_of, self.num_nodes)]
                    levels += [(polish_mod.contiguous_segments(P, m), m)
                               for m in coarse_segments if m < P]
                    precon = polish_mod.multilevel_rigid_preconditioner(
                        model0.hess_vp, nabla, (t, R), levels, precon)
                return polish_mod.polish_global(
                    self.edges, t, R, loss=self.loss,
                    loss_reg=self.loss_reg, params=params,
                    precondition=precon)

            self._polish_jits[key] = jax.jit(impl)
        t, R = self.gather_global(st)
        t, R = self._place_global(t, R)
        t2, R2, fx = self._polish_jits[key](self.probs, t, R)
        st2 = self.initialize(np.asarray(t2), np.asarray(R2))
        return st2, 2.0 * float(fx)

    def _place_global(self, t, R):
        """Placement hook for the gathered global pose state before the
        polish jit (the sharded solvers shard the pose axis over the mesh so
        the coupled TNT runs distributed; base class: single device)."""
        return t, R

    def refine_stats(self, st: MMState) -> dict:
        """Per-node, per-TNT-outer-iteration refinement profile for the
        CURRENT state: (f, |grad|, |Pgrad|, Delta, inner CG iterations, step
        M-norm, rho, accepted) ring buffers plus the refinement gate mask —
        the reference's TNTResult observability (TNT.h:168-194,
        DPGO_types.h:280-297) surfaced from the vmapped refinement.
        Diagnostic probe (re-runs the refinement outside the scan)."""
        if getattr(self, "_refine_probe_jit", None) is None:
            self._refine_probe_jit = jax.jit(
                lambda probs, s: mm_mod.refine_probe(probs, s, self.opts))
        refined, hist = self._refine_probe_jit(self.probs, st)
        out = {k: np.asarray(v) for k, v in hist._asdict().items()}
        out["refined_mask"] = np.asarray(refined)
        return out

    def node_stats(self, st: MMState) -> dict:
        """Per-node observability snapshot (the reference's DPGOResult
        per-iteration series, DPGO_types.h:204-298)."""
        return {
            "fobj": np.asarray(st.fobj),
            "gradFnorm": np.asarray(st.gradFnorm),
            "Gk": np.asarray(st.Gk),
            "Fk0": np.asarray(st.Fk0),
            "Fk1": np.asarray(st.Fk1),
            "gamma": np.asarray(st.gamma),
            "s": np.asarray(st.s),
            "soft_restart_hits": (np.asarray(st.hits0),
                                  np.asarray(st.hits1)),
            "num_oscillations": np.asarray(st.num_osc),
        }

    def run(self, num_iters: int, t0=None, R0=None, record_every: int = 1,
            callback=None, log_iterates: bool = False):
        """Run the solver; returns (state, history) where history rows are
        (iter, 2*fobj, 2*gradnorm) in the reference driver's convention.

        `callback(k, state, fobj2x, grad2x)` is invoked at every recorded
        iteration (the TNTUserFunction-style instrumentation hook,
        TNT.h:35-71); returning True stops the run early.

        `log_iterates=True` additionally keeps the global (t, R) iterate at
        every recorded iteration (reference Options::log_iterates,
        DPGO_types.h:197-199) and returns (state, history, iterates) with
        iterates a list of (t [P,d], R [P,d,d]) numpy pairs."""
        st = self.initialize(t0, R0)
        history = []
        iterates = []

        def record(st):
            if log_iterates:
                t, R = self.gather_global(st)
                iterates.append((np.asarray(t), np.asarray(R)))

        f, g = self._metrics(st)
        history.append((0, float(f), float(g)))
        record(st)
        stopped = callback is not None and callback(0, st, float(f),
                                                    float(g))
        k0 = jnp.zeros((), jnp.int32)
        done = 0
        while not stopped and done < num_iters:
            chunk = min(record_every, num_iters - done)
            st, k0 = self.run_steps(st, k0, chunk)
            done += chunk
            f, g = self._metrics(st)
            history.append((done, float(f), float(g)))
            record(st)
            if callback is not None and callback(done, st, float(f),
                                                 float(g)):
                break
        if log_iterates:
            return st, np.asarray(history), iterates
        return st, np.asarray(history)


class DPGOStarSolver(DPGOSolver):
    """AMM-PGO* — per-node accelerated steps with master-gated fallbacks
    using the exact global objective (reference DPGOStar)."""

    def _global_f(self, t_own, R_own):
        t = t_own[self.node_of, self.local_of]
        if self._c is not None:
            t = t + jnp.asarray(self._c, self.dtype)[self.node_of]
        R = R_own[self.node_of, self.local_of]
        return evaluate_f(self.edges, t, R, self.loss, self.loss_reg)

    def initialize(self, t=None, R=None, dist_init: bool = False):
        if R is None and dist_init:
            from dpgo_tpu.chordal import distributed_chordal_init
            t, R = distributed_chordal_init(self.meas, self.num_nodes,
                                            dtype=self.dtype)
        if R is None:
            R = chordal_initialization(self.meas)
        if t is None:
            t = recover_translations_global(self.meas, R)
        t = t - np.asarray(t).mean(axis=0, keepdims=True)
        self._set_gauge(t)
        Z = self.pack_global(t, R)
        st = star_mod.init_star_state(self.probs, Z, 0.0)
        st = st._replace(Z=communicate_star(st.Z, self.halo_owner,
                                            self.halo_lpose, self.halo_dc),
                         )
        st = st._replace(Z_prev=st.Z,
                         F=self._global_f(st.Z.t, st.Z.R))
        return jax.jit(partial(star_mod.update_star, opts=self.opts,
                               first=True))(self.probs, st)

    def _step_impl(self, probs, st, k):
        st = star_mod.iterate_star(probs, st, self.opts,
                                   self._global_f, k)
        st = st._replace(Z=communicate_star(st.Z, self.halo_owner,
                                            self.halo_lpose, self.halo_dc))
        return star_mod.update_star(probs, st, self.opts, first=False)

    def _metrics_impl(self, st):
        t, R = self.gather_global(st)
        f = evaluate_f(self.edges, t, R, self.loss, self.loss_reg)
        g = grad_norm(self.edges, t, R, self.loss, self.loss_reg)
        return 2.0 * f, 2.0 * g


def communicate_star(Z: NodeState, halo_owner, halo_lpose,
                     halo_dc=None) -> NodeState:
    th = Z.t[halo_owner, halo_lpose]
    if halo_dc is not None:
        th = th + halo_dc
    return NodeState(t=Z.t, R=Z.R, th=th,
                     Rh=Z.R[halo_owner, halo_lpose])
