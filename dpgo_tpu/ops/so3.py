"""Fast batched projection onto SO(3): branch-free Newton polar iteration.

The analog of the reference's hand-written AVX2 batched 3x3 SVD kernels
(C++/DPGO/include/DPGO/internal/svd3x3.h, project_to_SO3.h): XLA's generic
jnp.linalg.svd lowers to an iterative per-matrix solver, while the iteration
below is pure element-wise math over the batch.

The 3x3 matrices travel structure-of-arrays, as nine batch arrays (one per
entry, row-major), so every operation is element-wise across the batch and
XLA fuses the whole projection into a few kernels; stacking, reductions over
the 3x3 axes and gathers would each cut the fusion.

Method: scaled Higham-Newton iteration X <- (zeta X + (zeta X)^-T)/2 converges
quadratically to the orthogonal polar factor Q with det(Q) = sign(det(A)).
For det(A) < 0 the Frobenius-closest SO(3) matrix is not Q but
U diag(1, 1, -1) V^T = Q (I - 2 v3 v3^T), where v3 is the eigenvector of the
SPD factor H = Q^T A for its smallest eigenvalue — computed in closed form
(trigonometric eigenvalue formula + cross-product null vector), all
`jnp.where`-selected so the whole pipeline is branch-free and batchable.
"""

from __future__ import annotations

import jax.numpy as jnp

_NEWTON_ITERS = 9


def _mul(x, y):
    """3x3 product of two 9-tuples (row-major)."""
    return tuple(sum(x[3 * a + k] * y[3 * k + b] for k in range(3))
                 for a in range(3) for b in range(3))


def _transpose(x):
    return (x[0], x[3], x[6], x[1], x[4], x[7], x[2], x[5], x[8])


def _det(x):
    return (x[0] * (x[4] * x[8] - x[5] * x[7])
            - x[1] * (x[3] * x[8] - x[5] * x[6])
            + x[2] * (x[3] * x[7] - x[4] * x[6]))


def _adjugate_T(x):
    """Transpose of the adjugate (the cofactor matrix)."""
    return (x[4] * x[8] - x[5] * x[7], x[5] * x[6] - x[3] * x[8],
            x[3] * x[7] - x[4] * x[6], x[2] * x[7] - x[1] * x[8],
            x[0] * x[8] - x[2] * x[6], x[1] * x[6] - x[0] * x[7],
            x[1] * x[5] - x[2] * x[4], x[2] * x[3] - x[0] * x[5],
            x[0] * x[4] - x[1] * x[3])


def _fnorm2(x):
    return sum(v * v for v in x)


def _cross(r, s):
    return (r[1] * s[2] - r[2] * s[1], r[2] * s[0] - r[0] * s[2],
            r[0] * s[1] - r[1] * s[0])


def _clamp_away_from_zero(x, eps):
    return jnp.where(jnp.abs(x) > eps, x, jnp.where(x >= 0, eps, -eps))


def eps_for(dtype) -> float:
    """Clamp below which a norm or determinant counts as zero."""
    return 1e-30 if dtype == jnp.float64 else 1e-18


def polar_so3(A: jnp.ndarray) -> jnp.ndarray:
    """Project [..., 3, 3] onto SO(3) (Frobenius-closest, det fix included)."""
    a = tuple(A[..., i, j] for i in range(3) for j in range(3))
    R = polar_so3_entries(a, eps_for(A.dtype))
    return jnp.stack(R, axis=-1).reshape(A.shape)


def polar_so3_entries(a, eps):
    """The projection on nine same-shape arrays, the entries of the 3x3
    matrices in row-major order; returns the nine entries of the result.
    Element-wise only, so it also serves as a kernel body
    (ops/so3_triton.py)."""
    one, zero = jnp.ones_like(a[0]), jnp.zeros_like(a[0])
    ident = (one, zero, zero, zero, one, zero, zero, zero, one)

    # Normalize scale; degenerate (zero) input maps to identity.
    nrm = jnp.sqrt(_fnorm2(a))
    ok = nrm > eps
    inv_n = 1.0 / jnp.maximum(nrm, eps)
    X = tuple(jnp.where(ok, v * inv_n, i) for v, i in zip(a, ident))

    for _ in range(_NEWTON_ITERS):
        # X^-T via the adjugate, det clamped away from zero.
        det = _clamp_away_from_zero(_det(X), eps)
        Xit = tuple(v / det for v in _adjugate_T(X))
        # Higham Frobenius-norm scaling accelerates early iterations.
        zeta = jnp.sqrt(jnp.sqrt(_fnorm2(Xit) / jnp.maximum(_fnorm2(X), eps)))
        X = tuple(0.5 * (zeta * x + y / zeta) for x, y in zip(X, Xit))
    Q = X  # orthogonal, det = sign(det A)

    # det < 0 correction: Q (I - 2 v3 v3^T) with v3 the smallest-eigenvalue
    # eigenvector of H = sym(Q^T A) (SPD up to sign).
    H = _mul(_transpose(Q), a)
    H = tuple(0.5 * (x + y) for x, y in zip(H, _transpose(H)))
    q = (H[0] + H[4] + H[8]) / 3.0
    Hq = (H[0] - q, H[1], H[2], H[3], H[4] - q, H[5], H[6], H[7], H[8] - q)
    p = jnp.sqrt(jnp.maximum(_fnorm2(Hq) / 6.0, eps))
    r = jnp.clip(0.5 * _det(tuple(v / p for v in Hq)), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    M = (H[0] - lam3, H[1], H[2], H[3], H[4] - lam3, H[5],
         H[6], H[7], H[8] - lam3)
    # Null vector of M: the largest cross product of two of its rows.
    c01 = _cross(M[0:3], M[3:6])
    c12 = _cross(M[3:6], M[6:9])
    c20 = _cross(M[6:9], M[0:3])
    n01, n12, n20 = _fnorm2(c01), _fnorm2(c12), _fnorm2(c20)
    use12 = (n12 > n01) & (n12 >= n20)
    use20 = ~use12 & (n20 > n01)
    v = tuple(jnp.where(use12, x, jnp.where(use20, y, z))
              for x, y, z in zip(c12, c20, c01))
    vn = jnp.maximum(jnp.sqrt(_fnorm2(v)), eps)
    v = tuple(x / vn for x in v)
    refl = tuple((1.0 if i == j else 0.0) - 2.0 * v[i] * v[j]
                 for i in range(3) for j in range(3))
    Q_fixed = _mul(Q, refl)

    neg = _det(a) < 0
    return tuple(jnp.where(ok, jnp.where(neg, x, y), i)
                 for x, y, i in zip(Q_fixed, Q, ident))
