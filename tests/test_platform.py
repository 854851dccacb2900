"""The platform module, the chip table and the panel layout's jnp form."""

import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spgrid.core import platform
from spgrid.core.roofline import (
    CPU_HOST, H100_SXM, chip_for_kind, detect_chip, roofline_time)


def test_interpret_requires_explicit_allowance(monkeypatch):
    monkeypatch.setattr(platform, "_interpret_allowed", False)
    with pytest.raises(RuntimeError, match="allow_interpret"):
        platform.interpret()
    platform.allow_interpret()
    assert platform.interpret() is True


def test_interpret_never_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.interpret() is False


def test_pallas_route_is_triton():
    assert platform.PALLAS_BACKEND == "triton"


def test_unknown_device_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        chip_for_kind("gpu", "NVIDIA Imaginary 1")
    assert chip_for_kind("gpu", "NVIDIA H100 80GB HBM3") is H100_SXM
    assert detect_chip() is CPU_HOST          # the test backend


def test_roofline_nan_on_cpu_and_h100_bounds():
    assert math.isnan(roofline_time(1e9, 1e9, CPU_HOST))
    # 1 GB at 3.35 TB/s vs 67 GFLOP at 67 TFLOP/s: the larger bound wins
    assert roofline_time(67e9, 1e9, H100_SXM) == pytest.approx(1e-3)
    assert roofline_time(1e9, 3.35e9, H100_SXM) == pytest.approx(1e-3)


def test_compile_cache_honours_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert platform.setup_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before   # not overridden


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = platform.setup_compile_cache()
        assert path == platform.DEFAULT_CACHE_DIR
        assert path == os.path.join(platform.REPO_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert platform.setup_compile_cache() == path     # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_identity_label(monkeypatch):
    ident = platform.DeviceIdentity("gpu", "NVIDIA H100 80GB HBM3", 1,
                                    "NVIDIA H100 80GB HBM3, 700.00 W")
    assert ident.label == "NVIDIA H100 80GB HBM3 700.00 W"
    assert "," not in ident.label                   # one CSV cell
    assert ident.as_dict() == {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    cpu = platform.device_identity()
    assert cpu.platform == "cpu" and cpu.smi is None and cpu.label == "cpu"
    monkeypatch.setenv("PATH", "/nonexistent")
    assert platform.nvidia_smi() is None


@pytest.mark.parametrize("fmt", ["panel", "cv_panel"])
def test_panel_jnp_form_matches_f64(fmt):
    """The vertical-panel batched-matmul form against the f64 reference:
    exact values for panel; for cv_panel, bf16 A and X products."""
    import ml_dtypes
    from spgrid.formats import random_csr
    from spgrid.formats.cv import csr_to_cv, cv_to_csr
    from spgrid.ops.dispatch import build, spmm_fn
    csr = random_csr(300, 420, 0.04, seed=11)
    x = np.random.default_rng(4).random((420, 48)).astype(np.float32) + 0.5
    a = build(csr, fmt)
    with jax.default_matmul_precision("highest"):
        y = np.asarray(spmm_fn(fmt)(a, jnp.asarray(x)), np.float64)
    if fmt == "panel":
        gold = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
        tol = 1e-5
    else:
        aq = cv_to_csr(csr_to_cv(csr, "bf16")).to_dense().astype(np.float64)
        xq = x.astype(ml_dtypes.bfloat16).astype(np.float64)
        gold = aq @ xq
        tol = 1e-5
    assert y.shape == (300, 48)
    assert np.abs(y - gold).max() / np.abs(gold).max() < tol
