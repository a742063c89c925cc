"""Batched SO(3) projection as one Pallas kernel on the GPU (Triton route).

The body is `ops/so3.polar_so3_entries`, unchanged; the kernel only gives it
a layout. The nine entries of the 3x3 matrices travel as nine rows of the
batch, and each program projects `block` matrices held in registers, so the
whole Newton iteration is one launch with one read and one write of the
batch. XLA splits the same element-wise graph into several fusions that
pass intermediates through memory (timings on the H100 in PERF.md).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from dpgo_tpu.ops.so3 import eps_for, polar_so3_entries

_BLOCK = 128  # matrices per program (Triton blocks are powers of two)


def _kernel(*refs, eps):
    ins, outs = refs[:9], refs[9:]
    R = polar_so3_entries(tuple(r[...] for r in ins), eps)
    for out, r in zip(outs, R):
        out[...] = r


@functools.partial(jax.jit, static_argnames=("interpret",))
def polar_so3_triton(A: jnp.ndarray, interpret: bool = False) -> jnp.ndarray:
    """Project [..., 3, 3] onto SO(3); same result as ops/so3.polar_so3.

    The batch is zero-padded to whole blocks (zero maps to the identity).
    `interpret=True` runs the kernel in Pallas' interpreter, on any backend.
    """
    lead = A.shape[:-2]
    n = math.prod(lead)
    n_pad = -(-n // _BLOCK) * _BLOCK
    rows = jnp.pad(A.reshape(n, 9).T, ((0, 0), (0, n_pad - n)))
    spec = pl.BlockSpec((_BLOCK,), lambda i: (i,))
    R = pl.pallas_call(
        functools.partial(_kernel, eps=eps_for(A.dtype)),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), A.dtype)] * 9,
        grid=(n_pad // _BLOCK,),
        in_specs=[spec] * 9,
        out_specs=[spec] * 9,
        backend="triton",
        interpret=interpret,
        name="polar_so3_triton",
    )(*rows)
    return jnp.stack(R)[:, :n].T.reshape(A.shape)
