"""Batched SO(d)^n manifold operations on [n, d, d] tensors.

Equivalent of the reference's SOdProduct
(C++/DPGO/include/DPGO/SOdProduct.h) and its AVX projection kernels
(C++/DPGO/include/DPGO/internal/). Rotations are stored as true rotation
matrices R[i] (the reference stores transposed blocks inside its tall
((d+1)n x d) state matrix; the geometry below is storage-convention
invariant since the metric is Frobenius).

All functions are shape-polymorphic over leading batch axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dpgo_tpu.ops.so3 import polar_so3
from dpgo_tpu.ops.so3_triton import polar_so3_triton


def project_so2(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form projection of [..., 2, 2] onto SO(2).

    argmax_{R in SO(2)} <R, A> = [[a, -b], [b, a]] / sqrt(a^2+b^2) with
    a = A00 + A11, b = A10 - A01 (the reference's internal::project_to_SO2).
    """
    a = A[..., 0, 0] + A[..., 1, 1]
    b = A[..., 1, 0] - A[..., 0, 1]
    nrm = jnp.sqrt(a * a + b * b)
    # Degenerate A -> identity.
    safe = nrm > 0
    inv = jnp.where(safe, 1.0 / jnp.where(safe, nrm, 1.0), 1.0)
    c = jnp.where(safe, a * inv, 1.0)
    s = jnp.where(safe, b * inv, 0.0)
    row0 = jnp.stack([c, -s], axis=-1)
    row1 = jnp.stack([s, c], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def _project_svd(A: jnp.ndarray) -> jnp.ndarray:
    """SVD-based projection of [..., d, d] onto SO(d) with det fix.

    R = U diag(1, .., 1, det(UV^T)) V^T (reference project_to_SOd,
    DPGO_utils.h:462-483).
    """
    U, _, Vt = jnp.linalg.svd(A)
    detUVt = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d = A.shape[-1]
    flip = jnp.ones(A.shape[:-2] + (d,), dtype=A.dtype)
    flip = flip.at[..., -1].set(detUVt)
    return jnp.einsum("...ik,...k,...kj->...ij", U, flip, Vt)


def project_sod(A: jnp.ndarray) -> jnp.ndarray:
    """Project [..., d, d] matrices onto SO(d) (closest in Frobenius norm).

    d = 2: closed form; d = 3: branch-free batched Newton-polar iteration
    (ops/so3.py, the analog of the reference's AVX 3x3 SVD kernels), as one
    Triton kernel on the GPU, where it beats XLA's fusion of the same body
    (PERF.md), and as plain jnp elsewhere; other d: SVD fallback.
    """
    d = A.shape[-1]
    if d == 2:
        return project_so2(A)
    if d == 3:
        if jax.default_backend() == "gpu":
            return polar_so3_triton(A)
        return polar_so3(A)
    return _project_svd(A)


def sym(M: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def sym_block_diag_product(A: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray
                           ) -> jnp.ndarray:
    """Per-block sym(B_i^T C_i) applied to A_i: returns A_i @ sym(B_i^T C_i).

    Mirrors SOdProduct::SymBlockDiagProduct (SOdProduct.h:62-89) transcribed
    to true-rotation storage: P_i = A_i sym(B_i^T C_i).
    """
    S = sym(jnp.einsum("...ki,...kj->...ij", B, C))
    return jnp.einsum("...ik,...kj->...ij", A, S)


def proj_tangent(R: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """Project ambient V onto the tangent space of SO(d)^n at R.

    P = V - R sym(R^T V)  (SOdProduct::Proj, SOdProduct.h:95-103).
    """
    return V - sym_block_diag_product(R, R, V)


def retract(R: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """Add-then-project retraction (SOdProduct::retract, SOdProduct.h:110-116)."""
    return project_sod(R + V)


def random_rotations(key, n: int, d: int, dtype=jnp.float64) -> jnp.ndarray:
    A = jax.random.normal(key, (n, d, d), dtype=dtype)
    return project_sod(A)
