"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the reference's only radio-free entry point (m17_test.cpp): all
tests are digital, no SDR hardware.  Multi-device sharding tests use the
8 virtual CPU devices.  The CPU is the default platform; JAX_PLATFORMS
picks another.  Tests marked `gpu` need a CUDA GPU and skip without
one; on the card, `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`
runs them (`chip_smoke.py` covers the same kernels there).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips without one")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (run with JAX_PLATFORMS=cuda)")
