"""Test harness: the CPU backend with 8 virtual devices.

Correctness tests run on the CPU (``JAX_PLATFORMS=cpu``, the default
here); multi-device sharding tests run on a virtual 8-device CPU mesh.
Tests marked ``gpu`` need the card and skip elsewhere; on the card they
run with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernel.py``.

Once jax is imported, env vars alone are too late, so jax.config is
updated too before the backend initializes.
"""

import os

import pytest

_PLATFORM = os.environ.setdefault("JAX_PLATFORMS", "cpu")
if _PLATFORM == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The first device if it is a GPU; skips the test otherwise (decided
    when the test runs, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run on the card with JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/test_gpu_kernel.py")
    return dev
