"""MM-PGO and AMM-PGO# (decentralized, adaptive-restart) solvers.

Reproduces the reference DPGOHash per-node solver (C++/DPGO/src/DPGOHash.cpp)
as a masked state machine over a rectangular node axis:

- `update_state`  = DPGOHash::update (DPGOHash.cpp:84-228): surrogate anchors
  at the freshly-communicated Z, Nesterov s/gamma, exponential reference
  sequences Fk[0]/Fk[1], restart hit counters, oscillation window.
- `iterate_amm`   = DPGOHash::amm_pgo (DPGOHash.cpp:230-443): extrapolation,
  closed-form proximal step, optional TNT refinement, adaptive hard/soft
  restart cascade, phi-test.
- `iterate_mm`    = DPGOHash::mm_pgo (DPGOHash.cpp:446-581).

All per-node quantities live in arrays with a leading node axis; TNT runs
vmapped with a scalar `lax.cond` guard so the expensive refinement executes
only when at least one node needs it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from dpgo_tpu.manifold import (proj_tangent, project_sod,
                               sym_block_diag_product)
from dpgo_tpu.problem import NodeProblem, NodeState
from dpgo_tpu.solvers.tnt import TNTModel, TNTParams, tnt, tnt_generic



@dataclasses.dataclass(frozen=True)
class MMOptions:
    """Driver options (reference DPGO::Options defaults with the dist_pgo
    overrides, dist_pgo.cpp:103-120)."""

    accelerated: bool = True
    regularizer: float = 1e-11
    accepted_delta: float = 5e-4
    # Max admissible condition number of the regularized (dense / Jacobi)
    # STPCG preconditioner (reference
    # reg_Cholesky_precon_max_condition_number, DPGO_types.h:159). None =
    # auto by dtype: 1e6 (the reference default) in f64; 1e5 in f32, where a
    # 1e6-conditioned inverse amplifies rounding noise along mG11's
    # near-null space (on sphere2500 in f32, 1e5 took fewer iterations to
    # the same gap than 1e6).
    precon_cond: float | None = None
    rescale: str = "static"          # "static" | "dynamic" (robust losses)
    max_rescale_count: int = 5
    min_rescale: float = 0.01
    max_rescale: float = 1.0
    # Per-node objective sequence: True = the reference's exact Q-telescoping
    # (evaluate_none_g_and_f; carries an antisymmetric correction and, in
    # f32, a random-walk rounding drift that destabilizes the restart
    # references), False = direct edge-wise evaluation each update (fresh
    # ~1e-7-relative error, no drift). None = auto: telescoped in f64,
    # direct in f32 (resolved by the driver).
    telescoped: bool | None = None
    # Local gauge centering: store each node's translations relative to its
    # fixed block centroid (driver._set_gauge). Difference-based costs are
    # unchanged; f32 cancellation error drops from graph-diameter to
    # block-diameter scale. None = auto (on in f32, off in f64).
    local_gauge: bool | None = None
    # STPCG preconditioner for the TNT refinement — the reference's
    # Preconditioner enum (DPGO_types.h:35-40): "none" | "jacobi" |
    # "dense" (the regularized reduced-Hessian inverse = the
    # RegularizedCholesky role; also covers IncompleteCholesky's role —
    # no sparse triangular solves on the device). None = auto: "dense"
    # when the dense operator path is built, else "jacobi".
    preconditioner: str | None = None
    eta0: float = 5e-4
    eta1: float = 2.5e-2
    psi: float = 1e-10
    phi: float = 1e-6
    max_soft_restart_hits0: int = 10
    max_soft_restart_hits1: int = 25
    oscillation_cnt_period: int = 15
    max_oscillations: int = 12
    tnt: TNTParams = TNTParams()
    # Iteration scheme: None = "amm" when accelerated else "mm" (the two
    # reference schemes, DPGO::Scheme); "aa" = safeguarded Anderson
    # acceleration of the MM fixed point (no reference analog — an
    # extrapolation that fits the same per-node communicate/update loop; see
    # iterate_aa).
    scheme: str | None = None
    aa_window: int = 8        # Anderson history depth m
    aa_reg: float = 1e-8      # Tikhonov regularization of the normalized Gram
    # Safeguard: "monotone" accepts the Anderson candidate only when its
    # surrogate value does not exceed the anchor objective (keeps the global
    # objective monotone, since sum_a G_a(X_a|Z) >= f(X)); "none" always
    # accepts (diverges on hard graphs; for studies only).
    aa_safeguard: str = "monotone"
    # Re-solve translations exactly (min_t G given the Anderson rotations)
    # instead of keeping the extrapolated translations.
    aa_resolve_t: bool = False


def resolve_scheme(opts: MMOptions) -> str:
    if opts.scheme is not None:
        return opts.scheme
    return "amm" if opts.accelerated else "mm"


class MMState(NamedTuple):
    """Per-node solver state; every leaf has a leading node axis."""

    # Current anchor Z (own + halo) and previous anchor.
    Z: NodeState
    Z_prev: NodeState
    # Surrogate anchors at Z (and previous, for linear extrapolation).
    g_t: jnp.ndarray
    g_R: jnp.ndarray
    f: jnp.ndarray          # [N]
    fobj: jnp.ndarray       # [N] telescoped node objective
    Df_t: jnp.ndarray
    Df_R: jnp.ndarray
    g_t_prev: jnp.ndarray
    g_R_prev: jnp.ndarray
    Df_t_prev: jnp.ndarray
    Df_R_prev: jnp.ndarray
    fobj_prev: jnp.ndarray
    gradFnorm: jnp.ndarray  # [N]
    # Nesterov bookkeeping.
    Gk: jnp.ndarray         # [N] surrogate value at current own estimate
    Fk0: jnp.ndarray
    Fk1: jnp.ndarray
    s: jnp.ndarray          # [N] s_k
    s_next: jnp.ndarray     # [N] s_{k+1} (may be halved by hard restarts)
    gamma: jnp.ndarray
    hits0: jnp.ndarray      # [N] int32
    hits1: jnp.ndarray
    osc_buf: jnp.ndarray    # [N, oscillation_cnt_period + 2] int32, newest last
    num_osc: jnp.ndarray    # [N] int32
    # Dynamic rescale (robust losses): persisted surrogate weights + counter.
    scale_w: jnp.ndarray       # [N, m1]
    rescale_count: jnp.ndarray  # [N] int32
    # Anchor residual halves at Z, cached by update_state (computed there
    # anyway) so iterate's several evaluate_G_rel calls against the same Z
    # skip the anchor pass: ((z_rt, z_rR), (z_us, z_Es)) = zres.
    z_rt: jnp.ndarray       # [N, m0, d]
    z_rR: jnp.ndarray       # [N, m0, d, d]
    z_us: jnp.ndarray       # [N, m1, d]
    z_Es: jnp.ndarray       # [N, m1, d, d]
    # Anderson acceleration history (scheme="aa"; zero-sized otherwise).
    aa_dX: jnp.ndarray      # [N, m, D] iterate diffs, newest last
    aa_dR: jnp.ndarray      # [N, m, D] residual diffs, newest last
    aa_x_prev: jnp.ndarray  # [N, D] previous anchor (flattened own block)
    aa_r_prev: jnp.ndarray  # [N, D] previous residual
    aa_count: jnp.ndarray   # [N] int32 valid history length


def _flat_own(t: jnp.ndarray, R: jnp.ndarray) -> jnp.ndarray:
    """Flatten per-node own blocks (t [N,n,d], R [N,n,d,d]) to [N, D]."""
    N = t.shape[0]
    return jnp.concatenate([t.reshape(N, -1), R.reshape(N, -1)], axis=-1)


def _unflat_own(x: jnp.ndarray, t_like: jnp.ndarray, R_like: jnp.ndarray):
    N = t_like.shape[0]
    nt = t_like[0].size
    return (x[:, :nt].reshape(t_like.shape), x[:, nt:].reshape(R_like.shape))


def init_state(probs: NodeProblem, Z: NodeState,
               opts: MMOptions | None = None) -> MMState:
    N = Z.t.shape[0]
    zeros = jnp.zeros((N,), Z.t.dtype)
    m = opts.aa_window if (opts is not None
                           and resolve_scheme(opts) == "aa") else 0
    D = Z.t[0].size + Z.R[0].size if m else 0
    d = Z.t.shape[-1]
    return MMState(
        Z=Z, Z_prev=Z,
        g_t=jnp.zeros_like(Z.t), g_R=jnp.zeros_like(Z.R),
        f=zeros, fobj=zeros,
        Df_t=jnp.zeros_like(Z.t), Df_R=jnp.zeros_like(Z.R),
        g_t_prev=jnp.zeros_like(Z.t), g_R_prev=jnp.zeros_like(Z.R),
        Df_t_prev=jnp.zeros_like(Z.t), Df_R_prev=jnp.zeros_like(Z.R),
        fobj_prev=zeros, gradFnorm=zeros,
        Gk=zeros, Fk0=zeros, Fk1=zeros,
        s=jnp.ones((N,), Z.t.dtype), s_next=jnp.ones((N,), Z.t.dtype),
        gamma=zeros,
        hits0=jnp.zeros((N,), jnp.int32), hits1=jnp.zeros((N,), jnp.int32),
        osc_buf=jnp.ones(
            (N, (opts.oscillation_cnt_period if opts is not None else 15)
             + 2), jnp.int32),
        num_osc=jnp.zeros((N,), jnp.int32),
        scale_w=jnp.ones_like(probs.scale_w),
        rescale_count=jnp.zeros((N,), jnp.int32),
        z_rt=jnp.zeros(probs.a_i.shape + (d,), Z.t.dtype),
        z_rR=jnp.zeros(probs.a_i.shape + (d, d), Z.t.dtype),
        z_us=jnp.zeros(probs.e_self.shape + (d,), Z.t.dtype),
        z_Es=jnp.zeros(probs.e_self.shape + (d, d), Z.t.dtype),
        aa_dX=jnp.zeros((N, m, D), Z.t.dtype),
        aa_dR=jnp.zeros((N, m, D), Z.t.dtype),
        aa_x_prev=jnp.zeros((N, D), Z.t.dtype),
        aa_r_prev=jnp.zeros((N, D), Z.t.dtype),
        aa_count=jnp.zeros((N,), jnp.int32),
    )


def reweighted_problems(probs: NodeProblem, st: MMState, opts: MMOptions):
    """Problems with the state's persisted dynamic-rescale weights applied
    (identity when static / trivial loss)."""
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.problem import with_weights
    if opts.rescale != "dynamic" or probs.loss is Loss.TRIVIAL:
        return probs
    return jax.vmap(with_weights)(probs, st.scale_w)


# --------------------------------------------------------------------- update


def update_state(probs: NodeProblem, st: MMState, opts: MMOptions,
                 k: jnp.ndarray, first: bool) -> MMState:
    """DPGOHash::update — recompute surrogate anchors at the new Z and run the
    Nesterov/restart bookkeeping. `k` is the iteration index (0 at `first`).

    `probs` must be the BASE problems; the dynamic-rescale path recomputes
    the persisted weights here (evaluate_g_and_f0_rescale trigger,
    DPGOProblem.cpp:301-321) and reweights before the surrogate evaluations.
    """
    from dpgo_tpu.losses import Loss
    if opts.rescale == "dynamic" and probs.loss is not Loss.TRIVIAL:
        w_cur, _ = jax.vmap(lambda p, Z: p.inter_weights(Z))(probs, st.Z)
        exceeded = jnp.any(w_cur > st.scale_w, axis=1)
        rescaled = (st.rescale_count >= opts.max_rescale_count) | exceeded
        w_new = jnp.clip(1.25 * w_cur, opts.min_rescale, opts.max_rescale)
        scale_w = jnp.where(rescaled[:, None], w_new, st.scale_w)
        rescale_count = jnp.where(rescaled, 0, st.rescale_count + 1)
        st = st._replace(scale_w=scale_w, rescale_count=rescale_count)
        probs = reweighted_problems(probs, st, opts)

    assert opts.oscillation_cnt_period + 2 == st.osc_buf.shape[-1], (
        "state was initialized with a different oscillation_cnt_period; "
        "re-run init_state with these options")
    telescoped = opts.telescoped
    if telescoped is None:
        telescoped = st.Z.t.dtype == jnp.float64

    def per_node(p: NodeProblem, Z: NodeState, Z_prev: NodeState, Gk):
        from dpgo_tpu.losses import Loss
        if first or p.loss is not Loss.TRIVIAL or not telescoped:
            # Robust kernels / f32: evaluate the node objective directly
            # (the reference telescopes through Q + E-gradient bookkeeping,
            # evaluate_g_and_f, DPGOProblem.cpp:360-424; a direct edge-wise
            # evaluation is exact and cheaper here), fused with the
            # surrogate anchors so the edge arrays are gathered once.
            g, f, fobj, zres = p.surrogate_g_f_fobj_res(Z)
        else:
            g, _ = p.surrogate_g_f(Z)
            dZ = jax.tree.map(lambda a, b: a - b, Z, Z_prev)
            fobj = Gk + p.q_gap(dZ)
            f = fobj + p.p_form(Z)
            zres = p.anchor_residuals(Z.t, Z.R)
        Df = p.euclidean_Df(Z, g=g)
        grad_t, grad_R = Df[0], proj_tangent(Z.R, Df[1])
        gradnorm = jnp.sqrt(jnp.sum(grad_t * grad_t)
                            + jnp.sum(grad_R * grad_R))
        return g[0], g[1], f, fobj, Df[0], Df[1], gradnorm, zres

    g_t, g_R, f, fobj, Df_t, Df_R, gradFnorm, zres = jax.vmap(per_node)(
        probs, st.Z, st.Z_prev, st.Gk)

    if first:
        Fk0 = fobj
        Fk1 = fobj
        Gk = fobj
        fobj_prev = fobj
    else:
        Fk0, Fk1, Gk, fobj_prev = st.Fk0, st.Fk1, st.Gk, st.fobj

    if resolve_scheme(opts) == "amm":
        s0 = st.s_next if not first else st.s  # s_k (post-restart value)
        s1 = 0.5 + 0.5 * jnp.sqrt(4.0 * s0 * s0 + 1.0)
        gamma = (s0 - 1.0) / s1

        dec0 = fobj <= Fk1
        hits0 = jnp.where(dec0, jnp.maximum(st.hits0 - 2, 0), st.hits0 + 1)

        if first:
            hits1 = st.hits1
            osc_buf = st.osc_buf  # all ones; osc[0] = 1
            num_osc = st.num_osc
        else:
            dec = fobj <= fobj_prev
            hits1 = jnp.where(dec, 0, st.hits1 + 1)
            osc_new = dec.astype(jnp.int32)
            osc_buf = jnp.concatenate(
                [st.osc_buf[:, 1:], osc_new[:, None]], axis=1)
            # += osc[k] != osc[k-1]
            num_osc = st.num_osc + (osc_buf[:, -1] != osc_buf[:, -2])
            # -= osc[k-P] != osc[k-P-1] once k > P
            sub = (osc_buf[:, 1] != osc_buf[:, 0]).astype(jnp.int32)
            num_osc = num_osc - jnp.where(
                k > opts.oscillation_cnt_period, sub, 0)

        Fk0 = Fk0 * (1 - opts.eta0) + fobj * opts.eta0
        Fk1 = jnp.maximum(fobj, Fk1 * (1 - opts.eta1) + fobj * opts.eta1)
    else:
        s0, s1, gamma = st.s, st.s_next, st.gamma
        hits0, hits1 = st.hits0, st.hits1
        osc_buf, num_osc = st.osc_buf, st.num_osc
        Fk0 = fobj
        Fk1 = fobj

    return st._replace(
        g_t=g_t, g_R=g_R, f=f, fobj=fobj, Df_t=Df_t, Df_R=Df_R,
        g_t_prev=st.g_t if not first else g_t,
        g_R_prev=st.g_R if not first else g_R,
        Df_t_prev=st.Df_t if not first else Df_t,
        Df_R_prev=st.Df_R if not first else Df_R,
        fobj_prev=fobj_prev, gradFnorm=gradFnorm,
        Gk=Gk, Fk0=Fk0, Fk1=Fk1,
        s=s0, s_next=s1, gamma=gamma,
        hits0=hits0, hits1=hits1, osc_buf=osc_buf, num_osc=num_osc,
        z_rt=zres[0][0], z_rR=zres[0][1], z_us=zres[1][0], z_Es=zres[1][1],
    )


# -------------------------------------------------------------- TNT plumbing


def _make_tnt_model(p: NodeProblem, g_t, g_R, f, t_anchor=None,
                    precon: str = "jacobi", anchor=None) -> TNTModel:
    if anchor is not None:
        # f32-stable relative objective against the MM anchor (same role as
        # the dense model's evaluate_G_tall_rel): the anchor residual halves
        # are computed once at model build and reused by every evaluation.
        z_t, z_R, fobj = anchor
        zres = p.anchor_residuals(z_t, z_R)

        def objective(x):
            return p.evaluate_G_rel(z_t, z_R, x[0], x[1], (g_t, g_R), fobj,
                                    zres=zres)
    else:
        def objective(x):
            return p.evaluate_G(x[0], x[1], (g_t, g_R), f)

    def grad_and_nabla(x):
        nabla = p.reduced_euclidean_grad(x[0], x[1], g_R)
        return proj_tangent(x[1], nabla), nabla

    def hess_vp(x, nabla, v):
        return p.reduced_hessian_vp(x[1], nabla, v)

    if precon == "none":
        precondition = lambda x, v: v
    else:  # block-Jacobi (the only cheap option on the edge-wise path)
        precondition = lambda x, v: p.precondition(x[1], v)

    def retract(x, h):
        R_new = project_sod(x[1] + h)
        return p.recover_translations(R_new, g_t, t_anchor), R_new

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract)


def _make_tnt_model_dense(p: NodeProblem, g_t, g_Q, f,
                          t_anchor=None, precon: str = "dense",
                          anchor=None) -> TNTModel:
    """Dense-operator TNT model in tall Q-storage (variable (t, Q [n d, d])).

    `anchor` = (z_t, z_Q, fobj): evaluate the objective in the f32-stable
    relative form against the MM anchor (evaluate_G_tall_rel) — required for
    trust-region gain ratios to stay meaningful in f32 near convergence."""

    if anchor is not None:
        z_t, z_Q, fobj = anchor

        def objective(x):
            return p.evaluate_G_tall_rel(x[0], x[1], z_t, z_Q, g_t, g_Q,
                                         fobj)
    else:
        def objective(x):
            return p.evaluate_G_tall(x[0], x[1], g_t, g_Q, f)

    def grad_and_nabla(x):
        nabla = p.reduced_grad_tall(x[0], x[1], g_Q)
        return p.proj_tall(x[1], nabla), nabla

    def hess_vp(x, nabla, v):
        return p.hessian_vp_tall(x[1], nabla, v)

    if precon == "none":
        precondition = lambda x, v: v
    elif precon == "jacobi":
        precondition = lambda x, v: p.precondition_tall_jacobi(x[1], v)
    else:  # "dense": regularized reduced-Hessian inverse
        precondition = lambda x, v: p.precondition_tall(x[1], v)

    def retract(x, h):
        Qb = (x[1] + h).reshape(-1, p.d, p.d)
        Q_new = project_sod(Qb).reshape(x[1].shape)
        return p.recover_translations_tall(Q_new, g_t, t_anchor), Q_new

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract)


def _make_tnt_model_coupled(p: NodeProblem, g_t, g_R, f,
                            anchor=None) -> TNTModel:
    """Coupled (t, R) TNT model for the SEGMENT path (blocks past the
    dense/eigen-split limit — the regime the reference hands to CHOLMOD,
    DPGOProblem.cpp:93-124).

    The reduced (t-eliminated) model's Hessian-vector product needs one
    mG00 solve per STPCG iteration, which on the segment path would nest
    CG inside CG; the surrogate G is an exact quadratic in (t, R), so
    refining the COUPLED variable instead makes the hess-vp one edge-wise
    G_apply (no solves) and yields the same surrogate decrease guarantee
    (trust-region acceptance still evaluates the true G). Preconditioner:
    two-level segment-Schwarz for t + segment-dense regularized mG11
    inverses for R."""

    if anchor is not None:
        z_t, z_R, fobj = anchor

        def objective(x):
            return p.evaluate_G_rel(z_t, z_R, x[0], x[1], (g_t, g_R), fobj)
    else:
        def objective(x):
            return p.evaluate_G(x[0], x[1], (g_t, g_R), f)

    def grad_and_nabla(x):
        Gt, GR = p.G_apply(x[0], x[1])
        nt, nR = Gt + g_t, GR + g_R
        return (nt, proj_tangent(x[1], nR)), (nt, nR)

    def hess_vp(x, nabla, v):
        # G is linear, so G_apply(v) IS the (Euclidean) Hessian action.
        Ht, HR = p.G_apply(v[0], v[1])
        HR = HR - sym_block_diag_product(v[1], x[1], nabla[1])
        return (Ht, proj_tangent(x[1], HR))

    def precondition(x, v):
        return (p._precondition_t_seg(v[0]),
                proj_tangent(x[1], p.precondition_R_seg(v[1])))

    def retract(x, h):
        return (x[0] + h[0], project_sod(x[1] + h[1]))

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract)


def resolve_preconditioner(probs, opts: MMOptions) -> str:
    kind = opts.preconditioner
    if kind is None:
        return "dense" if probs.dense else "jacobi"
    if kind not in ("none", "jacobi", "dense"):
        raise ValueError(f"unknown preconditioner {kind!r}")
    if kind == "dense" and not probs.dense:
        raise ValueError("preconditioner='dense' needs the dense operator "
                         "path (raise dense_limit)")
    return kind


def _tnt_batch(probs, t0, R0, g_t, g_R, f, params: TNTParams,
               t_anchor=None, precon: str = "dense", anchor=None):
    if t_anchor is None:
        t_anchor = jnp.zeros_like(t0)
    if probs.dense:
        def one(p, t, R, gt, gR, fv, ta, anc):
            if anc is not None:
                anc = (anc[0], p.to_tall(anc[1]), anc[2])
            model = _make_tnt_model_dense(p, gt, p.to_tall(gR), fv, ta,
                                          precon, anchor=anc)
            x, fx, _, _ = tnt_generic(model, (t, p.to_tall(R)), params)
            return x[0], p.from_tall(x[1]), fx
    elif probs.seg:
        def one(p, t, R, gt, gR, fv, ta, anc):
            model = _make_tnt_model_coupled(p, gt, gR, fv, anchor=anc)
            x, fx, _, _ = tnt_generic(model, (t, R), params)
            return x[0], x[1], fx
    else:
        def one(p, t, R, gt, gR, fv, ta, anc):
            model = _make_tnt_model(p, gt, gR, fv, ta, precon, anchor=anc)
            tn, Rn, fx, _, _ = tnt(model, t, R, params)
            return tn, Rn, fx

    if anchor is None:
        one_fn = lambda p, t, R, gt, gR, fv, ta: one(p, t, R, gt, gR, fv,
                                                     ta, None)
        return jax.vmap(one_fn)(probs, t0, R0, g_t, g_R, f, t_anchor)
    return jax.vmap(one)(probs, t0, R0, g_t, g_R, f, t_anchor, anchor)


def _masked_tnt(probs, t0, R0, g_t, g_R, f, mask, params: TNTParams,
                fallback_G, t_anchor=None, precon: str = "dense",
                anchor=None):
    """Run batched TNT only if any node needs it; select per node by mask.
    Returns (t, R, G value at result).

    When TNT is statically disabled (max_iterations == 0) the TNT graph is
    not even traced — `lax.cond` would compile both branches, and the two
    inlined TNT instances dominate the step's compile time."""
    if params.max_iterations <= 0 or params.max_iterations_accepted <= 0:
        return t0, R0, fallback_G

    def run(_):
        tn, Rn, fx = _tnt_batch(probs, t0, R0, g_t, g_R, f, params,
                                t_anchor, precon, anchor)
        return (jnp.where(mask[:, None, None], tn, t0),
                jnp.where(mask[:, None, None, None], Rn, R0),
                jnp.where(mask, fx, fallback_G))

    def skip(_):
        return t0, R0, fallback_G

    return lax.cond(jnp.any(mask), run, skip, operand=None)


def refine_probe(probs, st: MMState, opts: MMOptions):
    """Re-run the AMM step's TNT refinement for the current state with full
    per-outer-iteration recording (the reference's TNTResult series,
    TNT.h:168-194) — the profiling window into the refined path's cost.

    Replays iterate_amm's extrapolation + proximal to reconstruct the exact
    TNT inputs of the next step, then runs the batched TNT with record=True
    for ALL nodes (ignoring the refinement gate, which is returned so the
    caller can mask). Returns (refined_mask [N] bool, TNTHistory with leading
    node axis). Diagnostic only — not part of the hot path.
    """
    from dpgo_tpu.losses import Loss

    gamma = st.gamma

    def extrap(cur, prev):
        g = gamma.reshape((-1,) + (1,) * (cur.ndim - 1))
        return cur + g * (cur - prev)

    Y = jax.tree.map(extrap, st.Z, st.Z_prev)
    if probs.loss is Loss.TRIVIAL:
        g_t_ex = extrap(st.g_t, st.g_t_prev)
        g_R_ex = extrap(st.g_R, st.g_R_prev)
        Df_t_ex = extrap(st.Df_t, st.Df_t_prev)
        Df_R_ex = extrap(st.Df_R, st.Df_R_prev)
    else:
        def reeval(p, Yn):
            g, _ = p.surrogate_g_f(Yn)
            Df = p.euclidean_Df(Yn, g=g)
            return g[0], g[1], Df[0], Df[1]

        g_t_ex, g_R_ex, Df_t_ex, Df_R_ex = jax.vmap(reeval)(probs, Y)

    refined = (((st.gradFnorm * st.gradFnorm / st.fobj) > opts.accepted_delta)
               | (st.num_osc >= opts.max_oscillations))

    th_t, th_R = jax.vmap(lambda p, z, dt, dR: p.proximal(z, (dt, dR)))(
        probs, Y, Df_t_ex, Df_R_ex)
    t_c = jax.vmap(lambda p, R, gt, ta: p.recover_translations(R, gt, ta))(
        probs, th_R, g_t_ex, Y.t)

    params = opts.tnt
    if params.max_iterations <= 0:
        params = dataclasses.replace(params, max_iterations=10)
    precon_kind = resolve_preconditioner(probs, opts)

    if probs.dense:
        def one(p, t, R, gt, gR, fv, ta, anc):
            anc = (anc[0], p.to_tall(anc[1]), anc[2])
            model = _make_tnt_model_dense(p, gt, p.to_tall(gR), fv, ta,
                                          precon_kind, anchor=anc)
            out = tnt_generic(model, (t, p.to_tall(R)), params, record=True)
            return out[4]
    elif probs.seg:
        def one(p, t, R, gt, gR, fv, ta, anc):
            model = _make_tnt_model_coupled(p, gt, gR, fv, anchor=anc)
            out = tnt_generic(model, (t, R), params, record=True)
            return out[4]
    else:
        def one(p, t, R, gt, gR, fv, ta, anc):
            model = _make_tnt_model(p, gt, gR, fv, ta, precon_kind,
                                    anchor=anc)
            out = tnt_generic(model, (t, R), params, record=True)
            return out[4]

    hist = jax.vmap(one)(probs, t_c, th_R, g_t_ex, g_R_ex, st.f, Y.t,
                         (st.Z.t, st.Z.R, st.fobj))
    return refined, hist


# -------------------------------------------------------------------- iterate


def _eval_G_batch(probs, st: MMState, t, R, zres=None):
    """G(X|Z) for candidate own states X, in the f32-stable relative form
    anchored at the current state's (Z, fobj, g). `zres` (from
    `_anchor_residuals_batch`) reuses the anchor residual halves across the
    several evaluations one iteration makes against the same Z."""
    if zres is None:
        return jax.vmap(lambda p, zt, zR, fo, gt, gR, xt, xR:
                        p.evaluate_G_rel(zt, zR, xt, xR, (gt, gR), fo))(
            probs, st.Z.t, st.Z.R, st.fobj, st.g_t, st.g_R, t, R)
    return jax.vmap(lambda p, zt, zR, fo, gt, gR, xt, xR, zr:
                    p.evaluate_G_rel(zt, zR, xt, xR, (gt, gR), fo, zres=zr))(
        probs, st.Z.t, st.Z.R, st.fobj, st.g_t, st.g_R, t, R, zres)


def _anchor_residuals_batch(probs, st: MMState):
    """Anchor residuals at Z — cached in the state by update_state (which
    evaluates the same Z at the end of the previous step)."""
    return ((st.z_rt, st.z_rR), (st.z_us, st.z_Es))


def _eval_G_pair_batch(probs, st: MMState, t1, t2, R, zres):
    """(G(t1, R | Z), G(t2, R | Z)) with the rotation work shared."""
    return jax.vmap(lambda p, zt, zR, fo, gt, gR, a, b, xR, zr:
                    p.evaluate_G_rel_pair(zt, zR, a, b, xR, (gt, gR), fo,
                                          zres=zr))(
        probs, st.Z.t, st.Z.R, st.fobj, st.g_t, st.g_R, t1, t2, R, zres)


def iterate_amm(probs: NodeProblem, st: MMState, opts: MMOptions,
                k: jnp.ndarray) -> MMState:
    """One AMM-PGO# iteration for all nodes (DPGOHash::amm_pgo)."""
    gamma = st.gamma

    def extrap(cur, prev):
        g = gamma.reshape((-1,) + (1,) * (cur.ndim - 1))
        return cur + g * (cur - prev)

    # Nesterov extrapolation of the full Z; (g, Df) extrapolate linearly for
    # the trivial loss, and are re-evaluated at Y for robust kernels
    # (DPGOHash.cpp:250-266).
    from dpgo_tpu.losses import Loss
    Y = jax.tree.map(extrap, st.Z, st.Z_prev)
    if probs.loss is Loss.TRIVIAL:
        g_t_ex = extrap(st.g_t, st.g_t_prev)
        g_R_ex = extrap(st.g_R, st.g_R_prev)
        Df_t_ex = extrap(st.Df_t, st.Df_t_prev)
        Df_R_ex = extrap(st.Df_R, st.Df_R_prev)
    else:
        def reeval(p, Yn):
            g, _ = p.surrogate_g_f(Yn)
            Df = p.euclidean_Df(Yn, g=g)
            return g[0], g[1], Df[0], Df[1]

        g_t_ex, g_R_ex, Df_t_ex, Df_R_ex = jax.vmap(reeval)(probs, Y)

    refined = (((st.gradFnorm * st.gradFnorm / st.fobj) > opts.accepted_delta)
               | (st.num_osc >= opts.max_oscillations))
    if opts.tnt.max_iterations <= 0 or opts.tnt.max_iterations_accepted <= 0:
        refined = jnp.zeros_like(refined)
    precon_kind = resolve_preconditioner(probs, opts)

    # Proximal step from the extrapolated point (Xakh).
    th_t, th_R = jax.vmap(lambda p, z, dt, dR: p.proximal(z, (dt, dR)))(
        probs, Y, Df_t_ex, Df_R_ex)
    zres = _anchor_residuals_batch(probs, st)

    diff_t = th_t - st.Z.t
    diff_R = th_R - st.Z.R
    minG = st.Fk0 - opts.psi * (
        jnp.sum(diff_t * diff_t, axis=(1, 2)) +
        jnp.sum(diff_R * diff_R, axis=(1, 2, 3)))

    # Candidate Xak: proximal rotations + translations re-solved with the
    # extrapolated g (DPGOHash.cpp:369-372).
    t_c = jax.vmap(lambda p, R, gt, ta: p.recover_translations(R, gt, ta))(
        probs, th_R, g_t_ex, Y.t)
    tnt_off = (opts.tnt.max_iterations <= 0
               or opts.tnt.max_iterations_accepted <= 0)
    if tnt_off:
        # Xakh and Xak share rotations: one fused pair evaluation.
        Gkh, Gk = _eval_G_pair_batch(probs, st, th_t, t_c, th_R, zres)
        Xak_t, Xak_R = t_c, th_R
    else:
        Gkh = _eval_G_batch(probs, st, th_t, th_R, zres)
        Xak_t, Xak_R, _ = _masked_tnt(probs, t_c, th_R, g_t_ex, g_R_ex,
                                      st.f, refined, opts.tnt, Gkh,
                                      t_anchor=Y.t, precon=precon_kind,
                                      anchor=(st.Z.t, st.Z.R, st.fobj))
        Gk = _eval_G_batch(probs, st, Xak_t, Xak_R, zres)

    # Exceptional-path cascade (DPGOHash.cpp:386-441): the proximal retry,
    # the adaptive hard/soft restarts, and the phi-test fallback. All three
    # fire rarely in steady state, but computing their candidates
    # unconditionally costs ~half the fast-path work (an extra proximal,
    # two translation solves, three surrogate evaluations, one TNT), so the
    # whole cascade runs under ONE scalar lax.cond. Semantics are identical:
    # the fast branch is the slow branch specialized to
    # need_retry = restart = use_h = False (under which Xakh = (th_t, th_R),
    # g_sel = g_t_ex, phi_t = t_c, and every where() collapses).
    need_retry = Gkh > minG
    hard = Gk > st.Fk0
    soft = ((Gk > st.Fk1) & (st.hits0 >= opts.max_soft_restart_hits0)) | \
           ((Gk > st.fobj) & (st.hits1 > opts.max_soft_restart_hits1))
    restart = hard | soft

    # The cascade is split into THREE scalar lax.conds (retry / restart /
    # phi-test) rather than one monolithic cond: on city10000 16-node the
    # phi-test alone fires on a sizable fraction of iterations, and under
    # one cond it dragged the full retry+restart+TNT recompute with it when
    # all it needs is one translation solve + one surrogate evaluation.
    # Each stage's branch is its exact slice of the reference cascade
    # (DPGOHash.cpp:386-441); the masked selects make the skip branch the
    # fired branch specialized to all-false flags, so the forced-slow
    # equality test still pins semantics.

    def slow_path(_):
        # Retry the un-extrapolated proximal if Gkh insufficient
        # (DPGOHash.cpp:386-389).
        tp_t, tp_R = jax.vmap(lambda p, z, dt, dR: p.proximal(z, (dt, dR)))(
            probs, st.Z, st.Df_t, st.Df_R)
        Gkp = _eval_G_batch(probs, st, tp_t, tp_R, zres)
        Xakh_t = jnp.where(need_retry[:, None, None], tp_t, th_t)
        Xakh_R = jnp.where(need_retry[:, None, None, None], tp_R, th_R)
        Gkh2 = jnp.where(need_retry, Gkp, Gkh)
        return Xakh_t, Xakh_R, Gkh2

    def fast_path(_):
        return th_t, th_R, Gkh

    Xakh_t, Xakh_R, Gkh2 = lax.cond(jnp.any(need_retry), slow_path,
                                    fast_path, operand=None)

    def restart_path(_):
        # Restart candidate: Xakh if good enough, else un-extrapolated
        # proximal; translations from g (non-extrapolated). The proximal
        # retry is recomputed here (deterministic, identical) because the
        # `~good` select needs it even for nodes where need_retry was
        # False — restarts are the rarest stage, so the duplicate work is
        # paid almost never instead of on every exceptional iteration.
        tp_t, tp_R = jax.vmap(lambda p, z, dt, dR: p.proximal(z, (dt, dR)))(
            probs, st.Z, st.Df_t, st.Df_R)
        good = Gkh2 <= st.fobj
        r_R = jnp.where(good[:, None, None, None], Xakh_R, tp_R)
        r_t = jax.vmap(lambda p, R, gt, ta: p.recover_translations(
            R, gt, ta))(probs, r_R, st.g_t, st.Z.t)
        r_G = _eval_G_batch(probs, st, r_t, r_R, zres)
        # Nodes with restart & refined get TNT refinement + its objective
        # value; restart & ~refined keep the evaluated proximal value.
        rt_t, rt_R, _ = _masked_tnt(
            probs, r_t, r_R, st.g_t, st.g_R, st.f, restart & refined,
            opts.tnt, r_G, t_anchor=st.Z.t, precon=precon_kind,
            anchor=(st.Z.t, st.Z.R, st.fobj))
        # Re-evaluate in the stable relative form (TNT's internal objective
        # is the absolute dense form, fine for its own accept/reject ratios
        # but too coarse in f32 to feed the restart comparisons).
        Gk_restart = _eval_G_batch(probs, st, rt_t, rt_R, zres)
        return (jnp.where(restart[:, None, None], rt_t, Xak_t),
                jnp.where(restart[:, None, None, None], rt_R, Xak_R),
                jnp.where(restart, Gk_restart, Gk))

    def restart_skip(_):
        return Xak_t, Xak_R, Gk

    Xk_t2, Xk_R2, Gk2 = lax.cond(jnp.any(restart), restart_path,
                                 restart_skip, operand=None)

    # phi-test: fall back to the proximal iterate Xakh if the refined
    # step made insufficient progress relative to it
    # (DPGOHash.cpp:434-441).
    use_h = (st.Fk0 - Gk2) < opts.phi * (st.Fk0 - Gkh2)

    def phi_path(_):
        g_sel_t = jnp.where(restart[:, None, None], st.g_t, g_t_ex)
        t_sel = jnp.where(restart[:, None, None], st.Z.t, Y.t)
        phi_t = jax.vmap(lambda p, R, gt, ta: p.recover_translations(
            R, gt, ta))(probs, Xakh_R, g_sel_t, t_sel)
        Xk_t = jnp.where(use_h[:, None, None], phi_t, Xk_t2)
        Xk_R = jnp.where(use_h[:, None, None, None], Xakh_R, Xk_R2)
        Gk3 = jnp.where(use_h,
                        _eval_G_batch(probs, st, Xk_t, Xk_R, zres), Gk2)
        return Xk_t, Xk_R, Gk3

    def phi_skip(_):
        return Xk_t2, Xk_R2, Gk2

    Xak_t2, Xak_R2, Gk_f = lax.cond(jnp.any(use_h), phi_path, phi_skip,
                                    operand=None)

    s_next = jnp.where(hard, jnp.maximum(0.5 * st.s_next, 1.0), st.s_next)
    hits0 = jnp.where(restart, st.hits0 // 3, st.hits0)
    hits1 = jnp.where(restart, 0, st.hits1)

    # Stamp: Z_prev <- Z, Z.own <- Xak (halo refreshed by communicate()).
    Z_new = NodeState(t=Xak_t2, R=Xak_R2, th=st.Z.th, Rh=st.Z.Rh)
    return st._replace(Z=Z_new, Z_prev=st.Z, Gk=Gk_f,
                       s_next=s_next, hits0=hits0, hits1=hits1)


def iterate_mm(probs: NodeProblem, st: MMState, opts: MMOptions,
               k: jnp.ndarray) -> MMState:
    """One plain MM-PGO iteration (DPGOHash::mm_pgo)."""
    refined = ((st.gradFnorm * st.gradFnorm / st.fobj) > opts.accepted_delta)
    if opts.tnt.max_iterations <= 0 or opts.tnt.max_iterations_accepted <= 0:
        refined = jnp.zeros_like(refined)

    th_t, th_R = jax.vmap(lambda p, z, dt, dR: p.proximal(z, (dt, dR)))(
        probs, st.Z, st.Df_t, st.Df_R)
    t_c = jax.vmap(lambda p, R, gt, ta: p.recover_translations(R, gt, ta))(
        probs, th_R, st.g_t, st.Z.t)
    zres = _anchor_residuals_batch(probs, st)
    G0 = _eval_G_batch(probs, st, t_c, th_R, zres)
    Xak_t, Xak_R, _ = _masked_tnt(probs, t_c, th_R, st.g_t, st.g_R, st.f,
                                  refined, opts.tnt, G0, t_anchor=st.Z.t,
                                  precon=resolve_preconditioner(probs, opts),
                                  anchor=(st.Z.t, st.Z.R, st.fobj))
    Gk = _eval_G_batch(probs, st, Xak_t, Xak_R, zres)

    Z_new = NodeState(t=Xak_t, R=Xak_R, th=st.Z.th, Rh=st.Z.Rh)
    return st._replace(Z=Z_new, Z_prev=st.Z, Gk=Gk)


def iterate_aa(probs: NodeProblem, st: MMState, opts: MMOptions,
               k: jnp.ndarray) -> MMState:
    """One safeguarded Anderson-accelerated MM iteration for all nodes.

    The MM loop is the fixed-point iteration X <- T(X), T = per-node
    closed-form surrogate minimization + halo exchange. Nesterov
    extrapolation (iterate_amm) uses one history step; Anderson acceleration
    (type II) uses the last `aa_window` steps: with residuals
    r_j = T(X_j) - X_j, it solves the small least-squares problem
    theta = argmin |r_k - dRhist theta| per node and extrapolates
    X+ = T(X_k) - (dXhist + dRhist) theta — a GMRES-like update that targets
    exactly the slow, smooth error modes that dominate long-tail graphs
    (large-diameter pose chains: city10000, MITb), where information flows
    one pose-graph hop per MM iteration.

    No reference analog (the reference's only extrapolation is Nesterov,
    DPGOHash.cpp:258-266); designed for the device: the history is a fixed
    [m, D] ring buffer per node, the solve is one m x m SPD system per node
    (Cholesky, m ~ 8), all inside the jitted scan step.

    Safeguard ("monotone"): accept the Anderson candidate only where its
    surrogate value G(X_aa | Z) does not exceed the anchor objective
    F^a(Z) = G(Z|Z); otherwise keep the plain proximal step (whose surrogate
    value never exceeds the anchor's, H-majorization). Since
    sum_a G_a(X_a|Z) >= f(X) for all X (paper's block-separable majorizer),
    the accepted global objective decreases monotonically.
    """
    # Plain MM candidate from the anchor: T(X_k) own block (iterate_mm's
    # proximal path, no TNT).
    th_t, th_R = jax.vmap(lambda p, z, dt, dR: p.proximal(z, (dt, dR)))(
        probs, st.Z, st.Df_t, st.Df_R)
    t_c = jax.vmap(lambda p, R, gt, ta: p.recover_translations(R, gt, ta))(
        probs, th_R, st.g_t, st.Z.t)

    xT = _flat_own(t_c, th_R)
    x = _flat_own(st.Z.t, st.Z.R)
    r = xT - x

    # Push (x - x_prev, r - r_prev) into the ring buffers (newest last);
    # slot is zeroed when there is no previous point yet.
    have = (st.aa_count > 0)[:, None]
    dx_new = jnp.where(have, x - st.aa_x_prev, 0.0)
    dr_new = jnp.where(have, r - st.aa_r_prev, 0.0)
    dX = jnp.concatenate([st.aa_dX[:, 1:], dx_new[:, None]], axis=1)
    dR = jnp.concatenate([st.aa_dR[:, 1:], dr_new[:, None]], axis=1)

    # Column-normalized regularized normal equations: empty slots have zero
    # norm -> unit scale, zero Gram row + lambda I diagonal -> theta_i = 0.
    nrm = jnp.sqrt(jnp.sum(dR * dR, axis=-1))                   # [N, m]
    scale = jnp.where(nrm > 0, nrm, 1.0)
    dRn = dR / scale[..., None]
    gram = jnp.einsum("nmd,nkd->nmk", dRn, dRn)
    rhs = jnp.einsum("nmd,nd->nm", dRn, r)
    m = gram.shape[-1]
    lam = opts.aa_reg + jnp.finfo(gram.dtype).eps
    gram = gram + lam * jnp.eye(m, dtype=gram.dtype)
    chol = jax.vmap(jax.scipy.linalg.cholesky, in_axes=(0,), out_axes=0)(
        gram)
    theta_n = jax.vmap(lambda c, b: jax.scipy.linalg.cho_solve((c, False),
                                                               b))(chol, rhs)
    theta = theta_n / scale

    x_aa = xT - jnp.einsum("nm,nmd->nd", theta, dX + dR)
    t_aa, R_raw = _unflat_own(x_aa, st.Z.t, st.Z.R)
    R_aa = project_sod(R_raw)
    if opts.aa_resolve_t:
        t_aa = jax.vmap(lambda p, R, gt, ta: p.recover_translations(
            R, gt, ta))(probs, R_aa, st.g_t, st.Z.t)

    zres = _anchor_residuals_batch(probs, st)
    G_aa = _eval_G_batch(probs, st, t_aa, R_aa, zres)
    if opts.aa_safeguard == "monotone":
        G_prox = _eval_G_batch(probs, st, t_c, th_R, zres)
        accept = G_aa <= st.fobj
    else:
        G_prox = G_aa
        accept = jnp.ones_like(st.aa_count, bool)

    Xak_t = jnp.where(accept[:, None, None], t_aa, t_c)
    Xak_R = jnp.where(accept[:, None, None, None], R_aa, th_R)
    Gk = jnp.where(accept, G_aa, G_prox)

    Z_new = NodeState(t=Xak_t, R=Xak_R, th=st.Z.th, Rh=st.Z.Rh)
    return st._replace(
        Z=Z_new, Z_prev=st.Z, Gk=Gk,
        aa_dX=dX, aa_dR=dR, aa_x_prev=x, aa_r_prev=r,
        aa_count=jnp.minimum(st.aa_count + 1, jnp.int32(2 ** 30)),
    )
