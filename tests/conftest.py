"""Test config.

Provisions 8 virtual CPU devices (used by tests/test_mesh.py via
jax.devices('cpu')) and pins the suite to the CPU backend, so runs are
hermetic and deterministic. Set X264_TEST_GPU=1 to leave JAX on its
default backend instead; tests marked `gpu` run only then, on a GPU, and
skip otherwise (`X264_TEST_GPU=1 python -m pytest tests/ -m gpu`)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("X264_TEST_GPU") != "1":
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long e2e encodes; excluded from the default gate lane "
        "(run the full suite with `pytest tests/`, the fast lane with "
        "`pytest tests/ -m 'not slow'`)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; runs with X264_TEST_GPU=1 and skips otherwise")
    # build the libavcodec decode oracle once per session (gitignored
    # binary; several e2e tests invoke it directly by path)
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    exe = os.path.join(tools, "avdec")
    if not os.path.exists(exe):
        import subprocess
        subprocess.run(
            ["gcc", "-O2", os.path.join(tools, "avdec.c"), "-o", exe,
             "-lavcodec", "-lavutil"], capture_output=True)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips unless X264_TEST_GPU=1 and JAX's
    default backend is a GPU. Decided here, at run time, so every
    worker collects the same tests."""
    if os.environ.get("X264_TEST_GPU") != "1":
        pytest.skip("needs a GPU: set X264_TEST_GPU=1 on a GPU host")
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"default JAX backend is {dev.platform}, not gpu")
    return dev
