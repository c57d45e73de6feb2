"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's WARP software-rasterizer fallback
(/root/reference/Common/d3dApp.cpp:435-444): the framework must run without
real accelerator hardware. Multi-chip sharding tests use the 8 virtual
devices. Tests marked ``gpu`` need the card and skip here; run them on a
GPU machine with ``python -m pytest tests/ -m gpu`` (chip_smoke.py runs
the same checks at full size).
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end comparison tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (skips with a reason elsewhere)")


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU (decided at test time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()}")
