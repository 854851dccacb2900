"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU: sharding logic on
``xla_force_host_platform_device_count=8`` virtual devices, Pallas kernels
in interpret mode.  Must run before jax is imported anywhere.  Tests that
need the card carry the ``gpu`` marker and skip here; chip_smoke.py runs
the same paths on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from spgrid.core import platform  # noqa: E402

platform.allow_interpret()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on the CPU")


@pytest.fixture(scope="session")
def test_consts():
    """A cost-model table for routing tests: values chosen for the tests
    (round numbers in a plausible range), not claimed as any machine's,
    so the tests check the models' logic rather than one card's table."""
    from spgrid.ops.costmodel import ChipConstants
    return ChipConstants(
        eff_bw=700e9, matmul_f32=35e12, matmul_bf16=200e12,
        gather_fast=2e8, gather_slow=5e7, gather_cliff=64e6,
        combine_bw=3e11, scoo_scatter=1e-8, dispatch=3e-6,
        source="test values")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this path "
                    "on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(14)
