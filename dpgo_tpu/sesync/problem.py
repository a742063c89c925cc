"""SE-Sync simplified (translation-eliminated) problem, matrix-free.

Equivalent of the reference's SESyncProblem with the Simplified
formulation (C++/SESync/include/SESync/SESyncProblem.h:36-363): the rank-r
relaxation minimizes F(Y) = 1/2 <Q Y, Y> over the product of Stiefel blocks,
where Q = L_Grho + Q_tau:

  L_Grho  rotation connection Laplacian (kappa weights)
  Q_tau   = V~^T Om^1/2 Pi Om^1/2 V~ with Pi the orthogonal projector onto
            ker(A_bar Om^1/2) (A_bar = reduced incidence), applied via a
            cached dense split-inverse of the reduced translation Laplacian
            (the reference caches a CHOLMOD/SPQR factor,
            SESyncProblem.cpp:93-103)

State layout: tall Q-storage Y [n d, r] with block rows Y_i in R^{d x r},
Y_i Y_i^T = I_d (at r = d, Y_i = R_i^T). All applications are edge-wise
gathers + batched einsums.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_tpu.io.g2o import Measurements
from dpgo_tpu.manifold import project_sod
from dpgo_tpu.solvers.tnt import TNTModel


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SESyncProblem:
    d: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    ei: jnp.ndarray      # [m]
    ej: jnp.ndarray      # [m]
    eR: jnp.ndarray      # [m, d, d]
    et: jnp.ndarray      # [m, d]
    kappa: jnp.ndarray   # [m]
    tau: jnp.ndarray     # [m]
    Lred_inv: jnp.ndarray  # [n-1, n-1] inverse reduced translation Laplacian
    jac_inv: jnp.ndarray   # [n, d, d] block-Jacobi preconditioner blocks
    # Host sparse-direct solve of the reduced translation Laplacian, used
    # instead of the dense Lred_inv matmul above `dense_limit` poses
    # (city10000/ais2klinik-class: the dense inverse costs O(n^3) ~ 15 min
    # and GBs at n=15k, where one SuperLU factorization is seconds).
    # Static: a plain callable, invoked through jax.pure_callback.
    lred_host: object = dataclasses.field(
        default=None, metadata=dict(static=True))
    # "simplified" (translation-eliminated, the default) or "sosync"
    # (rotation-only synchronization; Q = L_Grho) — the reference's
    # Formulation enum (SESync_types.h:29-46). The Explicit joint (t, R)
    # formulation is what the DPGO solvers themselves provide.
    formulation: str = dataclasses.field(
        default="simplified", metadata=dict(static=True))

    # ------------------------------------------------------- Q application

    def _blocks(self, Y):
        return Y.reshape(self.n, self.d, -1)

    def apply_LGrho(self, Y):
        """Rotation connection Laplacian in Q-storage tall layout."""
        B = self._blocks(Y)
        Bi = B[self.ei]
        Bj = B[self.ej]
        k = self.kappa[:, None, None]
        # (i,i): kappa B_i ; (i,j): -kappa R~ B_j ; etc.
        ci = k * (Bi - jnp.einsum("eab,ebr->ear", self.eR, Bj))
        cj = k * (Bj - jnp.einsum("eba,ebr->ear", self.eR, Bi))
        out = jnp.zeros_like(B)
        out = out.at[self.ei].add(ci).at[self.ej].add(cj)
        return out.reshape(Y.shape)

    def _lred_solve(self, u):
        """[n-1, r] reduced-Laplacian solve: dense cached inverse, or the
        host sparse factorization above dense_limit."""
        if self.lred_host is not None:
            return jax.pure_callback(
                self.lred_host,
                jax.ShapeDtypeStruct(u.shape, u.dtype), u,
                vmap_method="sequential")
        return jnp.einsum("pq,qr->pr", self.Lred_inv, u)

    def apply_Qtau(self, Y):
        """Translation-elimination term V~^T Om^1/2 Pi Om^1/2 V~ Y."""
        B = self._blocks(Y)
        st = jnp.sqrt(self.tau)
        # w = Om^1/2 V~ Y : [m, r]
        w = st[:, None] * jnp.einsum("ea,ear->er", self.et, B[self.ei])
        # u = A_bar Om^1/2 w (incidence: +1 at i, -1 at j; drop pose 0)
        u_full = jnp.zeros((self.n, w.shape[1]), Y.dtype)
        sw = st[:, None] * w
        u_full = u_full.at[self.ei].add(sw).at[self.ej].add(-sw)
        v = self._lred_solve(u_full[1:])
        v_full = jnp.concatenate(
            [jnp.zeros((1, w.shape[1]), Y.dtype), v], axis=0)
        w2 = w - st[:, None] * (v_full[self.ei] - v_full[self.ej])
        # back: V~^T Om^1/2 w2
        out = jnp.zeros_like(B)
        out = out.at[self.ei].add(
            self.et[:, :, None] * (st[:, None] * w2)[:, None, :])
        return out.reshape(Y.shape)

    def apply_Q(self, Y):
        if self.formulation == "sosync":
            return self.apply_LGrho(Y)
        return self.apply_LGrho(Y) + self.apply_Qtau(Y)

    def objective(self, Y):
        return 0.5 * jnp.sum(Y * self.apply_Q(Y))

    # ------------------------------------------------------- manifold ops

    def sym_block_product(self, A, B, C):
        """A_i sym(B_i C_i^T) per block (tall layout; mirrors
        SOdProduct::SymBlockDiagProduct in Q-storage)."""
        Ab, Bb, Cb = self._blocks(A), self._blocks(B), self._blocks(C)
        S = jnp.einsum("nar,nbr->nab", Bb, Cb)
        S = 0.5 * (S + jnp.swapaxes(S, -1, -2))
        return jnp.einsum("nab,nbr->nar", S, Ab).reshape(A.shape)

    def proj_tangent(self, Y, V):
        return V - self.sym_block_product(Y, Y, V)

    def project_blocks(self, A):
        """Per-block projection onto the Stiefel manifold: row-orthonormalize
        each [d, r] block via (B B^T)^(-1/2) B."""
        B = self._blocks(A)
        G = jnp.einsum("nar,nbr->nab", B, B)
        lam, V = jnp.linalg.eigh(G)
        inv_sqrt = jnp.einsum(
            "nab,nb,ncb->nac", V, 1.0 / jnp.sqrt(jnp.maximum(lam, 1e-12)), V)
        return jnp.einsum("nab,nbr->nar", inv_sqrt, B).reshape(A.shape)

    def retract(self, Y, V):
        return self.project_blocks(Y + V)

    def riemannian_grad(self, Y):
        return self.proj_tangent(Y, self.apply_Q(Y))

    def hess_vp(self, Y, nabla, V):
        """Proj(Q V - SymBlockDiag correction) (SESyncProblem.cpp, eq. (44)
        of the SE-Sync tech report)."""
        E = self.apply_Q(V) - self.sym_block_product(V, Y, nabla)
        return self.proj_tangent(Y, E)

    def precondition(self, Y, V):
        B = self._blocks(V)
        P = jnp.einsum("nab,nbr->nar", self.jac_inv, B).reshape(V.shape)
        return self.proj_tangent(Y, P)

    def tnt_model(self) -> TNTModel:
        return TNTModel(
            objective=lambda Y: self.objective(Y),
            grad_and_nabla=lambda Y: (
                self.proj_tangent(Y, self.apply_Q(Y)), self.apply_Q(Y)),
            hess_vp=lambda Y, nabla, V: self.hess_vp(Y, nabla, V),
            precondition=lambda Y, V: self.precondition(Y, V),
            retract=lambda Y, V: self.retract(Y, V),
        )

    # ------------------------------------------------------- certification

    def Lambda_blocks(self, Y):
        """Dual certificate blocks: Lambda_i = sym((Q Y)_i Y_i^T)
        (SESyncProblem::compute_Lambda_blocks)."""
        QY = self._blocks(self.apply_Q(Y))
        Yb = self._blocks(Y)
        L = jnp.einsum("nar,nbr->nab", QY, Yb)
        return 0.5 * (L + jnp.swapaxes(L, -1, -2))

    def apply_S(self, Lam, V):
        """S v = Q v - Lambda v with Lambda block-diagonal."""
        B = self._blocks(V)
        return self.apply_Q(V) - jnp.einsum(
            "nab,nbr->nar", Lam, B).reshape(V.shape)

    # ------------------------------------------------------- solution IO

    def round_solution(self, Y):
        """Rank-d rounding: global SVD to the top-d subspace, then per-block
        SO(d) projection with det alignment (SESync round_solution)."""
        U, s, Vt = jnp.linalg.svd(Y, full_matrices=False)
        Yd = U[:, :self.d] * s[:self.d]  # [nd, d]
        Q = Yd.reshape(self.n, self.d, self.d)
        # Align global reflection: majority determinant vote.
        dets = jnp.linalg.det(jnp.swapaxes(Q, -1, -2))
        flip = jnp.where(jnp.sum(jnp.sign(dets)) < 0, -1.0, 1.0)
        Q = Q.at[..., :, -1].multiply(flip)
        R = project_sod(jnp.swapaxes(Q, -1, -2))
        return R

    def recover_translations(self, R):
        """Optimal translations given rotations, t[0] = 0."""
        c = jnp.einsum("eab,eb->ea", R[self.ei], self.et)
        b = jnp.zeros((self.n, self.d), R.dtype)
        tw = self.tau[:, None] * c
        b = b.at[self.ei].add(-tw).at[self.ej].add(tw)
        t1 = self._lred_solve(b[1:])
        return jnp.concatenate([jnp.zeros((1, self.d), R.dtype), t1], axis=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SESyncExplicit:
    """Explicit formulation: joint minimization over (t [n, r], Y [n d, r]).

    The reference's Formulation::Explicit (SESync_types.h:29-46,
    SESyncProblem.h:36-363) keeps translations as explicit variables instead
    of eliminating them through the cached Cholesky/QR projection — the rank-r
    lift places both the translations and the Stiefel blocks in R^r:

        F(t, Y) = 1/2 sum_e  tau_e |t_i + Y_i^T t~_e - t_j|^2
                           + kappa_e |R~_e^T Y_i - Y_j|_F^2

    Euclidean x Stiefel-product geometry; the quadratic's gradient/Hessian are
    obtained by autodiff (exact — F is quadratic in (t, Y)); the Riemannian
    Hessian adds the usual Stiefel curvature correction on the Y part.
    """

    base: SESyncProblem
    Ldiag_inv: jnp.ndarray  # [n] Jacobi inverse of the tau-Laplacian diagonal

    def objective(self, x):
        t, Y = x
        B = self.base._blocks(Y)
        Bi = B[self.base.ei]
        rt = (t[self.base.ei]
              + jnp.einsum("ear,ea->er", Bi, self.base.et)
              - t[self.base.ej])
        rR = jnp.einsum("eab,ear->ebr", self.base.eR, Bi) - B[self.base.ej]
        return 0.5 * (jnp.sum(self.base.tau * jnp.sum(rt * rt, -1))
                      + jnp.sum(self.base.kappa * jnp.sum(rR * rR, (-1, -2))))

    def _eucl_grad(self, x):
        return jax.grad(self.objective)(x)

    def proj_tangent(self, x, v):
        return (v[0], self.base.proj_tangent(x[1], v[1]))

    def riemannian_grad(self, x, nabla=None):
        if nabla is None:
            nabla = self._eucl_grad(x)
        return self.proj_tangent(x, nabla)

    def hess_vp(self, x, nabla, v):
        _, Hv = jax.jvp(self._eucl_grad, (x,), (v,))
        HvY = Hv[1] - self.base.sym_block_product(v[1], x[1], nabla[1])
        return self.proj_tangent(x, (Hv[0], HvY))

    def precondition(self, x, v):
        pt = self.Ldiag_inv[:, None] * v[0]
        pY = self.base.precondition(x[1], v[1])
        return (pt, pY)

    def retract(self, x, v):
        return (x[0] + v[0], self.base.project_blocks(x[1] + v[1]))

    def tnt_model(self) -> TNTModel:
        def grad_and_nabla(x):
            nabla = self._eucl_grad(x)
            return self.proj_tangent(x, nabla), nabla

        return TNTModel(
            objective=self.objective,
            grad_and_nabla=grad_and_nabla,
            hess_vp=self.hess_vp,
            precondition=self.precondition,
            retract=self.retract,
        )


def build_sesync_explicit(meas: Measurements,
                          dtype=jnp.float64) -> SESyncExplicit:
    base = build_sesync_problem(meas, dtype=dtype)
    Ldiag = np.zeros((meas.num_poses,))
    np.add.at(Ldiag, meas.i, meas.tau)
    np.add.at(Ldiag, meas.j, meas.tau)
    # The tau-Laplacian is singular along the all-ones gauge direction; the
    # Jacobi diagonal is strictly positive on connected graphs.
    return SESyncExplicit(base=base,
                          Ldiag_inv=jnp.asarray(1.0 / Ldiag, dtype))


def build_sesync_problem(meas: Measurements, dtype=jnp.float64,
                         formulation: str = "simplified",
                         dense_limit: int = 4096) -> SESyncProblem:
    P, d, m = meas.num_poses, meas.d, len(meas)
    tau, i, j = meas.tau, meas.i, meas.j
    lred_host = None
    if P > dense_limit:
        # Sparse-direct reduced-Laplacian solve (host, via pure_callback):
        # the dense inverse is O(P^3) time and O(P^2) memory — ~15 min and
        # 1.8 GB at ais2klinik's 15k poses, vs seconds for one SuperLU
        # factorization of the (very sparse) graph Laplacian.
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        Lsp = sp.coo_matrix(
            (np.concatenate([tau, tau, -tau, -tau]),
             (np.concatenate([i, j, i, j]), np.concatenate([i, j, j, i]))),
            shape=(P, P)).tocsc()
        lu = spla.splu(Lsp[1:, 1:].tocsc())

        def lred_host(u):
            u = np.asarray(u)
            return lu.solve(np.asarray(u, np.float64)).astype(u.dtype)

        Lred_inv = np.zeros((1, 1))
    else:
        L = np.zeros((P, P))
        np.add.at(L, (i, i), tau)
        np.add.at(L, (j, j), tau)
        np.add.at(L, (i, j), -tau)
        np.add.at(L, (j, i), -tau)
        Lred_inv = np.linalg.inv(L[1:, 1:])

    jac = np.zeros((P, d, d))
    eye = np.eye(d)
    np.add.at(jac, i, meas.kappa[:, None, None] * eye)
    np.add.at(jac, j, meas.kappa[:, None, None] * eye)
    lam_max = np.abs(jac).sum(axis=(1, 2)).max()
    jac += (lam_max / 1e6) * eye
    jac_inv = np.linalg.inv(jac)

    cast = lambda x: jnp.asarray(x, dtype)
    return SESyncProblem(
        d=d, n=P, m=m,
        ei=jnp.asarray(i, jnp.int32), ej=jnp.asarray(j, jnp.int32),
        eR=cast(meas.R), et=cast(meas.t),
        kappa=cast(meas.kappa), tau=cast(meas.tau),
        Lred_inv=cast(Lred_inv), jac_inv=cast(jac_inv),
        formulation=formulation, lred_host=lred_host,
    )
