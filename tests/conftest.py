"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Must run before the first jax import anywhere in the test session.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

DATASET_DIR = "/root/reference/dataset"


def dataset_path(name: str) -> str:
    path = os.path.join(DATASET_DIR, name)
    if not os.path.exists(path):
        pytest.skip(f"dataset {name} not available")
    return path


@pytest.fixture
def rng():
    return np.random.default_rng(42)
