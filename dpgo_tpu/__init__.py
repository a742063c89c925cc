"""dpgo_tpu: distributed pose-graph optimization (MM-PGO family) in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
C++ DPGO implementation (Fan & Murphey, IEEE T-RO 2024).
"""

import jax as _jax

# An f32 matmul at the default precision may run in reduced precision (TF32
# tensor cores on the GPU, ~1e-3 relative error) — ruinous for a
# second-order optimizer whose restart logic compares nearby objective
# values. Force full-f32 matmuls by default; the few matvecs that tolerate
# TF32 ask for it explicitly (problem.py hessian_vp_tall /
# precondition_tall). f64 paths are unaffected.
_jax.config.update("jax_default_matmul_precision", "highest")

from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.graph import partition_measurements, build_multigraph

__version__ = "0.1.0"

__all__ = [
    "read_g2o_file",
    "partition_measurements",
    "build_multigraph",
]
