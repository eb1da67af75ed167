"""Test configuration.

The suite runs on the CPU with 8 virtual XLA devices, so sharding semantics
are exercised without a multi-card machine (SURVEY.md §4.2 'fake-backend
note'). Both settings are made before jax is imported: JAX reads
JAX_PLATFORMS at import and XLA_FLAGS when the backend client is created.

Tests of the CUDA kernel carry the `gpu` marker and skip off the card. On a
GPU machine they run with:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="session")
def _assert_cpu_mesh():
    if jax.default_backend() == "cpu":
        assert len(jax.devices()) == 8
    yield


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a GPU (decided here, at run time,
    so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
