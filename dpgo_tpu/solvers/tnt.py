"""Riemannian truncated-Newton trust-region (TNT) with Steihaug-Toint
preconditioned truncated CG, as fixed-shape JAX loops.

Re-implements the reference's Optimization::Riemannian::TNT
(C++/Optimization/include/Optimization/Riemannian/TNT.h:244-640) and
LinearAlgebra::STPCG (IterativeSolvers.h:166-450) — the inner solver of every
MM iteration and of the SE-Sync staircase — as `lax.while_loop`s over pytree
states, so the whole refine step stays inside one jit and vmaps over the node
axis.

Generic over pytree variables and tangent vectors: for DPGO the variable is
(t [n, d], R [n, d, d]) with rotation-space tangents; for SE-Sync the
variable is a Stiefel-product block Y [n, r, d] with its own tangents.

Instrumentation (reference TNT.h:35-71 user hook and TNT.h:168-194 result
series): `record=True` returns a TNTHistory of per-outer-iteration
(f, |grad|, |Pgrad|, Delta, inner CG iterations, step M-norm, rho, accepted)
ring buffers, written device-side inside the loop; `user_fn` is a host
callback invoked once per outer iteration with the same quantities (plus the
candidate step), whose boolean return forces early termination — the
TNTUserFunction semantics. user_fn runs via jax.pure_callback (sequential
under vmap; intended for host-driven solvers: polish, SE-Sync staircase).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@dataclasses.dataclass(frozen=True)
class TNTParams:
    """Mirrors Optimization::Riemannian::TNTParams defaults (TNT.h:76-130)
    with the dist_pgo driver overrides applied by callers."""

    gradient_tolerance: float = 1e-3
    preconditioned_gradient_tolerance: float = 1e-4
    relative_decrease_tolerance: float = 1e-6
    stepsize_tolerance: float = 1e-4
    Delta_tolerance: float = 1e-6
    Delta0: float = 1.0
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    max_iterations: int = 10
    max_iterations_accepted: int = 1
    # The reference defaults to 10000 (DPGO_types.h:167); with the dense
    # regularized preconditioner STPCG needs <10 iterations, and a hard cap
    # bounds worst-case step time (all vmapped lanes run until the slowest
    # finishes). Truncation only shortens the Newton step — trust-region
    # acceptance still guards quality.
    max_tCG_iterations: int = 250
    kappa_fgr: float = 0.05
    theta: float = 0.9
    # f32 noise-floor gate (see step_core): stop refining when the first
    # CG step's PRECONDITIONED model-decrease estimate 1/2 g^T P g falls
    # below objective-evaluation noise. The estimate is only meaningful
    # when the preconditioner spans the full tangent space: a node-block
    # preconditioner that excludes inter-node coupling makes 1/2 g^T P g
    # structurally ~0 at any bulk-converged state, and the gate would
    # misread the remaining coupled decrease as noise (the round-4
    # city10000 polish regression). The default None therefore DERIVES
    # the gate from TNTModel.precon_spans_full_space — models whose
    # preconditioner deliberately drops coupling declare it False and the
    # gate disables itself structurally. Explicit True/False overrides.
    noise_floor_gate: bool | None = None


class TNTModel(NamedTuple):
    """Problem closures for TNT (all pure functions of pytrees).

    objective(x) -> scalar value
    grad_and_nabla(x) -> (riemannian_grad, euclidean_nabla) tangent pytrees
    hess_vp(x, nabla, v) -> tangent pytree
    precondition(x, v) -> tangent pytree
    retract(x, v) -> new variable pytree
    precon_spans_full_space: declare False when `precondition` omits part
        of the tangent space (e.g. the polish's node-block preconditioner
        excludes inter-node coupling) — it disables the f32 noise-floor
        gate, whose model-decrease estimate 1/2 g^T P g is only a valid
        noise proxy for a full-span preconditioner (see TNTParams).
    """

    objective: Callable
    grad_and_nabla: Callable
    hess_vp: Callable
    precondition: Callable
    retract: Callable
    precon_spans_full_space: bool = True


class TNTHistory(NamedTuple):
    """Per-outer-iteration series (ring buffers of length max_iterations;
    entries [0, count) are valid). The on-device analog of the reference's
    TNTResult vectors (TNT.h:168-194, DPGO_types.h:280-297)."""

    fx: jnp.ndarray          # objective BEFORE the iteration's step
    gradnorm: jnp.ndarray
    pgradnorm: jnp.ndarray
    Delta: jnp.ndarray
    inner_iterations: jnp.ndarray  # STPCG iteration count (int32)
    h_M_norm: jnp.ndarray    # step norm in the preconditioner metric
    rho: jnp.ndarray         # gain ratio
    accepted: jnp.ndarray    # bool
    count: jnp.ndarray       # scalar int32: valid entries


def _ip(a, b):
    """Frobenius inner product over arbitrary pytrees of arrays."""
    la = jax.tree.leaves(a)
    lb = jax.tree.leaves(b)
    return sum(jnp.sum(x * y) for x, y in zip(la, lb))


def _axpy(alpha, x, y):
    """y + alpha * x treewise (alpha scalar)."""
    return jax.tree.map(lambda a, b: b + alpha * a, x, y)


def _scale(alpha, x):
    return jax.tree.map(lambda a: alpha * a, x)


def _sel(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def stpcg(grad, hess_vp, precon, Delta, params: TNTParams, v0=None,
          At=None, active=None):
    """Steihaug-Toint truncated preconditioned CG (IterativeSolvers.h:166-450).

    Returns (step, H @ step, step_M_norm, num_iterations). hess_vp/precon
    close over the current iterate. `v0` optionally supplies precon(grad)
    when the caller has already computed it (saves one application).
    The H @ step product is accumulated alongside the step so the caller's
    model-decrease evaluation costs no extra Hessian-vector product.

    Constrained variant (reference IterativeSolvers.h:166-450 `At`
    argument): with `At` supplied, `precon` must be a CONSTRAINT
    preconditioner returning (v, lambda) — the solution of the saddle
    system [[M, A^T], [A, 0]] [v; lambda] = [r; 0] — and the residual is
    re-projected by r <- r - At(lambda) after every preconditioner
    application (Gould/Hribar/Nocedal Sec. 6: keeps the multiplier
    component small so v retains relative accuracy). The iterates then stay
    in ker(A).

    `active` (scalar bool): False returns the zero step without iterating —
    used by vmapped TNT so below-noise lanes don't drag the shared batched
    CG loop to their (unreachable) residual targets.
    """
    eps = 1e-8
    if At is not None:
        v0, lam0 = precon(grad)
        grad = _axpy(-1.0, At(lam0), grad)
    elif v0 is None:
        v0 = precon(grad)
    r0v0 = _ip(grad, v0)
    r0_norm = jnp.sqrt(r0v0)
    target = r0_norm * jnp.minimum(params.kappa_fgr, r0_norm ** params.theta)
    Delta2 = Delta * Delta

    class S(NamedTuple):
        s: object
        Hs: object
        r: object
        v: object
        p: object
        sk_M_pk: jnp.ndarray
        sk_M_2: jnp.ndarray
        pk_M_2: jnp.ndarray
        k: jnp.ndarray
        done: jnp.ndarray
        norm_out: jnp.ndarray  # final |s|_M (set on boundary exits)

    zero = _scale(0.0, grad)
    done0 = (r0_norm <= target) | (r0_norm == 0.0)
    if active is not None:
        done0 = done0 | (~active)
    init = S(s=zero, Hs=zero, r=grad, v=v0, p=_scale(-1.0, v0),
             sk_M_pk=jnp.zeros_like(r0v0), sk_M_2=jnp.zeros_like(r0v0),
             pk_M_2=r0v0, k=jnp.zeros((), jnp.int32),
             done=done0,
             norm_out=jnp.zeros_like(r0v0))

    def cond(st: S):
        return (~st.done) & (st.k < params.max_tCG_iterations)

    def body(st: S):
        Hp = hess_vp(st.p)
        kappa_k = _ip(st.p, Hp)
        p_norm = jnp.sqrt(_ip(st.p, st.p))
        Hp_norm = jnp.sqrt(_ip(Hp, Hp))
        in_kernel = Hp_norm < eps * p_norm

        def sigma_of(sk_M_pk):
            disc = sk_M_pk * sk_M_pk + st.pk_M_2 * (Delta2 - st.sk_M_2)
            return (-sk_M_pk + jnp.sqrt(jnp.maximum(disc, 0.0))) / st.pk_M_2

        # Kernel exit: follow p (sign-fixed to descent) to the boundary.
        p_desc = jnp.where(_ip(st.p, st.r) < 0, -1.0, 1.0)
        sigma_kernel = sigma_of(st.sk_M_pk * p_desc) * p_desc
        s_kernel = _axpy(sigma_kernel, st.p, st.s)
        Hs_kernel = _axpy(sigma_kernel, Hp, st.Hs)

        rv = _ip(st.r, st.v)
        alpha = rv / kappa_k
        sk1_M_2 = st.sk_M_2 + 2 * alpha * st.sk_M_pk \
            + alpha * alpha * st.pk_M_2
        bad = (kappa_k <= 0) | (sk1_M_2 > Delta2)
        sigma_b = sigma_of(st.sk_M_pk)
        s_boundary = _axpy(sigma_b, st.p, st.s)
        Hs_boundary = _axpy(sigma_b, Hp, st.Hs)

        # Interior CG update.
        s_new = _axpy(alpha, st.p, st.s)
        Hs_new = _axpy(alpha, Hp, st.Hs)
        r_new = _axpy(alpha, Hp, st.r)
        if At is not None:
            v_new, lam = precon(r_new)
            r_new = _axpy(-1.0, At(lam), r_new)
        else:
            v_new = precon(r_new)
        rv_new = _ip(r_new, v_new)
        beta = rv_new / (alpha * kappa_k)
        sk_M_pk_new = beta * (st.sk_M_pk + alpha * st.pk_M_2)
        pk_M_2_new = rv_new + beta * beta * st.pk_M_2
        p_new = _axpy(beta, st.p, _scale(-1.0, v_new))
        interior_done = jnp.sqrt(rv_new) <= target

        exit_boundary = in_kernel | bad
        s_exit = _sel(in_kernel, s_kernel, s_boundary)
        Hs_exit = _sel(in_kernel, Hs_kernel, Hs_boundary)

        return S(
            s=_sel(exit_boundary, s_exit, s_new),
            Hs=_sel(exit_boundary, Hs_exit, Hs_new),
            r=_sel(exit_boundary, st.r, r_new),
            v=_sel(exit_boundary, st.v, v_new),
            p=_sel(exit_boundary, st.p, p_new),
            sk_M_pk=jnp.where(exit_boundary, st.sk_M_pk, sk_M_pk_new),
            sk_M_2=jnp.where(exit_boundary, st.sk_M_2, sk1_M_2),
            pk_M_2=jnp.where(exit_boundary, st.pk_M_2, pk_M_2_new),
            k=st.k + 1,
            done=exit_boundary | interior_done,
            norm_out=jnp.where(exit_boundary, Delta, st.norm_out),
        )

    out = lax.while_loop(cond, body, init)
    norm = jnp.where(out.norm_out > 0, out.norm_out, jnp.sqrt(out.sk_M_2))
    return out.s, out.Hs, norm, out.k


class TNTState(NamedTuple):
    x: object
    fx: jnp.ndarray
    grad: object
    nabla: object
    pgrad: object
    gradnorm: jnp.ndarray
    pgradnorm: jnp.ndarray
    Delta: jnp.ndarray
    k: jnp.ndarray
    accepted: jnp.ndarray
    done: jnp.ndarray
    hist: TNTHistory


def _empty_history(max_iterations: int, dtype) -> TNTHistory:
    m = max_iterations
    z = jnp.zeros((m,), dtype)
    return TNTHistory(fx=z, gradnorm=z, pgradnorm=z, Delta=z,
                      inner_iterations=jnp.zeros((m,), jnp.int32),
                      h_M_norm=z, rho=z,
                      accepted=jnp.zeros((m,), bool),
                      count=jnp.zeros((), jnp.int32))


def tnt_generic(model: TNTModel, x0, params: TNTParams,
                record: bool = False, user_fn: Callable | None = None):
    """Run TNT from pytree variable x0. Faithful to TNT.h:422-640.

    Returns (x, fx, gradnorm, num_accepted), plus a TNTHistory as a fifth
    element when `record=True`. `user_fn(**stats) -> bool` is the reference
    TNTUserFunction hook (TNT.h:35-71): called on the host once per outer
    iteration with keyword stats (k, fx, gradnorm, pgradnorm, Delta,
    inner_iterations, h_M_norm, rho, accepted, all 0-d numpy) — returning
    True terminates the solve after the current iteration.
    """
    dtype = jax.tree.leaves(x0)[0].dtype
    sqrt_eps = jnp.sqrt(jnp.finfo(dtype).eps)
    rec = record or (user_fn is not None)

    def eval_at(x):
        fx = model.objective(x)
        grad, nabla = model.grad_and_nabla(x)
        gradnorm = jnp.sqrt(_ip(grad, grad))
        pg = model.precondition(x, grad)
        pgradnorm = jnp.sqrt(_ip(pg, pg))
        return fx, grad, nabla, pg, gradnorm, pgradnorm

    fx0, grad0, nabla0, pg0, gn0, pgn0 = eval_at(x0)
    init = TNTState(
        x=x0, fx=fx0, grad=grad0, nabla=nabla0, pgrad=pg0, gradnorm=gn0,
        pgradnorm=pgn0, Delta=jnp.asarray(params.Delta0, dtype),
        k=jnp.zeros((), jnp.int32), accepted=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        hist=_empty_history(max(params.max_iterations, 1) if rec else 0,
                            dtype))

    def cond(st: TNTState):
        return ((~st.done) & (st.k < params.max_iterations)
                & (st.accepted < params.max_iterations_accepted))

    def step_core(st: TNTState):
        # Noise-floor guard: the first CG step's model decrease is
        # ~ 1/2 g^T P g; when that is below the working precision's
        # objective-evaluation noise, accept/reject gain ratios are coin
        # flips — in f32 such lanes reject noise steps and burn the whole
        # outer budget while dragging every vmapped lane's shared CG loop.
        # Stop refining instead. Inactive in f64, where the floor
        # (~1e-14 |f|) is below anything the reference's own
        # relative_decrease_tolerance would accept.
        grad_small = ((st.gradnorm < params.gradient_tolerance)
                      | (st.pgradnorm
                         < params.preconditioned_gradient_tolerance))
        gate_on = (model.precon_spans_full_space
                   if params.noise_floor_gate is None
                   else params.noise_floor_gate)
        if gate_on:
            dm_est = 0.5 * _ip(st.grad, st.pgrad)
            noise_floor = 16.0 * jnp.finfo(dtype).eps \
                * (1.0 + jnp.abs(st.fx))
            grad_small = grad_small | (dm_est < noise_floor)

        h, Hh, h_M_norm, inner_k = stpcg(
            st.grad,
            lambda v: model.hess_vp(st.x, st.nabla, v),
            lambda v: model.precondition(st.x, v),
            st.Delta, params, v0=st.pgrad, active=~grad_small)
        h_norm = jnp.sqrt(_ip(h, h))

        x_prop = model.retract(st.x, h)
        fx_prop = model.objective(x_prop)
        dm = -_ip(st.grad, h) - 0.5 * _ip(h, Hh)
        df = st.fx - fx_prop
        rel_decrease = df / (sqrt_eps + jnp.abs(st.fx))
        rho = df / dm
        step_ok = (~jnp.isnan(rho)) & (rho > params.eta1)

        # Derivatives of the accepted point are NOT evaluated here: the
        # loop body refreshes them at iteration start instead, so the final
        # accepted step (the only step, in the MM refinement's 1-accepted
        # regime) never pays a gradient + preconditioner evaluation nobody
        # consumes. grad/pgrad in the returned state therefore refer to the
        # last EVALUATED point (pre-step when the exit was acceptance).
        x_new = _sel(step_ok, x_prop, st.x)
        fx_new = jnp.where(step_ok, fx_prop, st.fx)
        grad_new = st.grad
        nabla_new = st.nabla
        pg_new = st.pgrad
        gn_new = st.gradnorm
        pgn_new = st.pgradnorm

        stop_rel = step_ok & (rel_decrease
                              < params.relative_decrease_tolerance)
        stop_step = step_ok & (h_norm < params.stepsize_tolerance)

        very_ok = (~jnp.isnan(rho)) & (rho >= params.eta2)
        Delta_up = jnp.maximum(params.alpha2 * h_M_norm, st.Delta)
        Delta_down = params.alpha1 * h_M_norm
        Delta_new = jnp.where(very_ok, Delta_up,
                              jnp.where(step_ok, st.Delta, Delta_down))
        stop_delta = (~step_ok) & (Delta_new < params.Delta_tolerance)

        keep = ~grad_small
        took = keep & step_ok

        hist = st.hist
        if rec:
            i = st.k
            upd = lambda a, v: a.at[i].set(jnp.where(keep, v, a[i]))
            hist = TNTHistory(
                fx=upd(hist.fx, st.fx),
                gradnorm=upd(hist.gradnorm, st.gradnorm),
                pgradnorm=upd(hist.pgradnorm, st.pgradnorm),
                Delta=upd(hist.Delta, st.Delta),
                inner_iterations=upd(hist.inner_iterations, inner_k),
                h_M_norm=upd(hist.h_M_norm, h_M_norm),
                rho=upd(hist.rho, rho),
                accepted=upd(hist.accepted, took),
                count=hist.count + keep.astype(jnp.int32),
            )

        done = grad_small | stop_rel | stop_step | stop_delta
        if user_fn is not None:
            def _call(live, k, fx, gn, pgn, Delta, ik, hM, rho_, acc):
                if not bool(live):  # gradient-tolerance exit: no user call
                    return np.bool_(False)
                return np.bool_(bool(user_fn(
                    k=k, fx=fx, gradnorm=gn, pgradnorm=pgn, Delta=Delta,
                    inner_iterations=ik, h_M_norm=hM, rho=rho_,
                    accepted=acc)))

            stop_user = jax.pure_callback(
                _call, jax.ShapeDtypeStruct((), np.bool_),
                keep, st.k, fx_new, gn_new, pgn_new, Delta_new, inner_k,
                h_M_norm, rho, took, vmap_method="sequential")
            done = done | stop_user

        return TNTState(
            x=_sel(keep, x_new, st.x),
            fx=jnp.where(keep, fx_new, st.fx),
            grad=_sel(keep, grad_new, st.grad),
            nabla=_sel(keep, nabla_new, st.nabla),
            pgrad=_sel(keep, pg_new, st.pgrad),
            gradnorm=jnp.where(keep, gn_new, st.gradnorm),
            pgradnorm=jnp.where(keep, pgn_new, st.pgradnorm),
            Delta=jnp.where(keep, Delta_new, st.Delta),
            k=st.k + 1,
            accepted=st.accepted + took,
            done=done,
            hist=hist,
        )

    def body(st: TNTState):
        # Iterations >= 2 start by refreshing the derivatives of the
        # current iterate (stale after an accepted step; recomputation is a
        # no-op after a rejection). The first iteration is peeled below and
        # reuses the init evaluation directly.
        grad_r, nabla_r = model.grad_and_nabla(st.x)
        gn_r = jnp.sqrt(_ip(grad_r, grad_r))
        pg_r = model.precondition(st.x, grad_r)
        pgn_r = jnp.sqrt(_ip(pg_r, pg_r))
        return step_core(st._replace(grad=grad_r, nabla=nabla_r,
                                     pgrad=pg_r, gradnorm=gn_r,
                                     pgradnorm=pgn_r))

    if params.max_iterations <= 0 or params.max_iterations_accepted <= 0:
        out = init
    else:
        peeled = step_core(init)
        out = lax.while_loop(cond, body, peeled)
    if record:
        return out.x, out.fx, out.gradnorm, out.accepted, out.hist
    return out.x, out.fx, out.gradnorm, out.accepted


def tnt(model: TNTModel, t0, R0, params: TNTParams):
    """DPGO-shaped entry: variable (t, R); returns (t, R, fx, gradnorm,
    num_accepted)."""
    x, fx, gn, acc = tnt_generic(model, (t0, R0), params)
    return x[0], x[1], fx, gn, acc
