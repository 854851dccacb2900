"""GELL (gather-ELL) hypersparse SpMM kernel tests.

Reference regime: spmm_kernel_mkl_ie.cpp:75-104 (5-100 nnz/row, n=512).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from spgrid.core.metrics import error_metrics
from spgrid.gen.artificial import artificial_matrix_generation
from spgrid.ops.gell import DeviceGELL, gell_spmm, _split_planes


def _gold(csr, x):
    xs = x.astype(np.float64)
    rows = np.repeat(np.arange(csr.m), csr.degrees)
    prods = csr.values[:, None].astype(np.float64) * xs[csr.col_idx]
    out = np.zeros((csr.m, x.shape[1]), np.float64)
    np.add.at(out, rows, prods)
    return out


@pytest.mark.parametrize("mode,tol", [("split24", 5e-6), ("f32", 5e-6),
                                      ("split16", 5e-4), ("bf16", 5e-2)])
def test_gell_modes_accuracy(mode, tol):
    csr = artificial_matrix_generation(777, 777, 6, 2.0, "normal", seed=3,
                                       placement="random", bw=0.3)
    x = np.random.default_rng(0).standard_normal((777, 64)) \
        .astype(np.float32)
    a = DeviceGELL.from_csr(csr, mode=mode)
    y = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
    m = error_metrics(_gold(csr, x), y, epsilon=1e-4)
    assert m.mape < tol, (mode, m.mape)


def test_gell_split24_matches_f32_exactly():
    csr = artificial_matrix_generation(500, 500, 5, 1.7, "normal", seed=7,
                                       placement="random", bw=0.05)
    x = np.random.default_rng(1).standard_normal((500, 32)) \
        .astype(np.float32)
    y24 = np.asarray(gell_spmm(DeviceGELL.from_csr(csr, mode="split24"),
                               jnp.asarray(x)), np.float64)
    yf = np.asarray(gell_spmm(DeviceGELL.from_csr(csr, mode="f32"),
                              jnp.asarray(x)), np.float64)
    # exact plane/value splits: differences are f32 summation-order only
    denom = np.maximum(np.abs(yf), 1e-3)
    assert np.abs(y24 - yf).max() / denom.max() < 1e-5


def test_split_planes_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(5000)
         * 10.0 ** rng.integers(-30, 30, 5000)).astype(np.float32)
    ps = _split_planes(jnp.asarray(x.reshape(-1, 1)), 3)
    rec = sum(np.asarray(p, np.float64) for p in ps)[:, 0]
    assert np.array_equal(rec.astype(np.float32), x)


def test_gell_skewed_tail():
    csr = artificial_matrix_generation(999, 999, 8, 40.0, "gamma", seed=5,
                                       placement="random", bw=0.9)
    a = DeviceGELL.from_csr(csr)
    assert a.tail_rows.shape[0] > 0          # skew actually exercises tail
    x = np.random.default_rng(2).standard_normal((999, 16)) \
        .astype(np.float32)
    y = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
    m = error_metrics(_gold(csr, x), y, epsilon=1e-4)
    assert m.mape < 5e-6


def test_gell_spmv_vector():
    csr = artificial_matrix_generation(300, 300, 4, 1.0, "normal", seed=9,
                                       placement="random", bw=0.5)
    x = np.random.default_rng(3).standard_normal(300).astype(np.float32)
    y = np.asarray(gell_spmm(DeviceGELL.from_csr(csr), jnp.asarray(x)))
    assert y.shape == (300,)
    gold = _gold(csr, x[:, None])[:, 0]
    assert np.allclose(y, gold, atol=1e-4, rtol=1e-4)


def test_gell_empty_and_dense_rows():
    # rows with zero nnz and a full row
    row_ptr = np.array([0, 0, 5, 5, 8], np.int64)
    col = np.array([0, 1, 2, 3, 4, 0, 2, 3], np.int64)
    val = np.arange(1, 9, dtype=np.float32)
    from spgrid.formats.csr import CSRMatrix
    csr = CSRMatrix(row_ptr, col, val, (4, 5), "tiny")
    x = np.eye(5, dtype=np.float32)
    y = np.asarray(gell_spmm(DeviceGELL.from_csr(csr), jnp.asarray(x)))
    assert np.allclose(y, csr.to_dense() @ x)


def test_cost_model_regime_picks(test_consts):
    """Cost-based dispatch lands the known regime winners (small-m dense
    was the worst miss of threshold rules)."""
    from spgrid.features.structural import matrix_features
    from spgrid.ops.dispatch import select_format

    small_dense = artificial_matrix_generation(
        4000, 4000, 100, 33.0, "normal", seed=14, placement="random",
        bw=0.95)
    # rbh is in the accepted set: its density branch (hi_frac -> 1 when
    # density*128^2 clears the block-admission threshold) makes rbh
    # block-dense execution plus a column perm on this class
    assert select_format(matrix_features(small_dense), 512,
                         consts=test_consts) in (
        "dense", "bsr_pallas", "panel", "rbh")

    # scattered hypersparse: merge, sell and gell are the gather kernels
    # of this regime — any of the three is a correct pick
    hyper = artificial_matrix_generation(
        60000, 60000, 5, 1.7, "normal", seed=14, placement="random", bw=0.9)
    assert select_format(matrix_features(hyper), 512,
                         consts=test_consts) in ("gell", "merge", "sell")

    # SpMV goes through the same models, over the XLA gather family
    from spgrid.ops.costmodel import SPMV_CANDIDATES
    assert select_format(matrix_features(hyper), 1,
                         consts=test_consts) in SPMV_CANDIDATES


def test_gell_windowed_banded():
    """k > SPAN_CAP banded: the windowed scan path engages and is exact."""
    csr = artificial_matrix_generation(40000, 40000, 5, 1.7, "normal",
                                       seed=11, placement="random", bw=0.05)
    a = DeviceGELL.from_csr(csr, mode="f32")
    assert a.win_plan is not None, "banded matrix should plan windows"
    x = np.random.default_rng(4).standard_normal((40000, 16)) \
        .astype(np.float32)
    y = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
    m = error_metrics(_gold(csr, x), y, epsilon=1e-4)
    assert m.mape < 5e-6, m.mape

    ab = DeviceGELL.from_csr(csr, mode="bf16")
    yb = np.asarray(gell_spmm(ab, jnp.asarray(x)), np.float64)
    mb = error_metrics(_gold(csr, x), yb, epsilon=1e-4)
    assert mb.mape < 5e-2

    # r3: windowed split16 — one [hi|lo] wide gather + MXU block-diagonal
    # combine; error floor is the X hi/lo representation (~2^-17 rel)
    a16 = DeviceGELL.from_csr(csr, mode="split16")
    assert a16.win_plan is not None
    y16 = np.asarray(gell_spmm(a16, jnp.asarray(x)), np.float64)
    m16 = error_metrics(_gold(csr, x), y16, epsilon=1e-4)
    assert m16.mape < 5e-4, m16.mape

    # r3: both windowed-f32 combine engines are f32-exact and agree
    import spgrid.ops.gell as gell_mod
    old = gell_mod.WIN_F32_COMBINE
    try:
        gell_mod.WIN_F32_COMBINE = "vpu"
        yv = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
        mv = error_metrics(_gold(csr, x), yv, epsilon=1e-4)
        assert mv.mape < 5e-6, mv.mape
        np.testing.assert_allclose(yv, y, rtol=1e-5, atol=1e-5)
    finally:
        gell_mod.WIN_F32_COMBINE = old


def test_gell_windowed_skips_scattered():
    csr = artificial_matrix_generation(40000, 40000, 5, 1.7, "normal",
                                       seed=11, placement="random", bw=0.9)
    a = DeviceGELL.from_csr(csr, mode="f32")
    assert a.win_plan is None
    x = np.random.default_rng(5).standard_normal((40000, 8)) \
        .astype(np.float32)
    y = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
    m = error_metrics(_gold(csr, x), y, epsilon=1e-4)
    assert m.mape < 5e-6, m.mape


def test_fit_constants_roundtrip():
    import pandas as pd
    from spgrid.ops import costmodel

    base = dict(csr_m=50000, csr_k=50000, csr_nnz=300000, input_columns=512,
                avg_nnz_per_row=6.0, std_nnz_per_row=2.0,
                avg_bw_scaled=0.05, std_bw_scaled=0.01, skew=1.0,
                errors_passed=1, fmt="gell")
    f = costmodel.MatrixFeatures(
        name="", m=50000, n=50000, nnz=300000, density=1.2e-4,
        mem_footprint=0.0, mem_range="", avg_nnz_per_row=6.0,
        std_nnz_per_row=2.0, min_nnz_per_row=0, max_nnz_per_row=12,
        avg_bw=2500.0, std_bw=500.0, avg_bw_scaled=0.05,
        std_bw_scaled=0.01, avg_sc=0, std_sc=0, avg_sc_scaled=0,
        std_sc_scaled=0, skew=1.0, avg_num_neighbours=0,
        cross_row_similarity=0)
    pred = costmodel.estimate_spmm_time(f, "gell", 512)
    try:
        df = pd.DataFrame([dict(base, time=2 * pred)] * 4)
        fitted = costmodel.fit_constants(df)
        assert abs(fitted["gell"] - 2.0) < 0.2
        # the installed correction doubles subsequent estimates
        assert abs(costmodel.estimate_spmm_time(f, "gell", 512)
                   / pred - 2.0) < 0.3
    finally:
        costmodel.C.fudge.clear()


def test_gell_chunked_scan_path(monkeypatch):
    """Multi-chunk (lax.scan) path: tiny budget forces nb > 1."""
    from spgrid.ops import gell as gmod

    monkeypatch.setattr(gmod, "_CHUNK_BUDGET", 1 << 16)
    csr = artificial_matrix_generation(3000, 3000, 6, 2.0, "normal",
                                       seed=8, placement="random", bw=0.9)
    x = np.random.default_rng(6).standard_normal((3000, 32)) \
        .astype(np.float32)
    a = DeviceGELL.from_csr(csr, mode="f32")
    assert a.win_plan is None
    y = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
    m = error_metrics(_gold(csr, x), y, epsilon=1e-4)
    assert m.mape < 5e-6, m.mape


def test_gell_bf16_wideband_window():
    """r3: the window cap is source BYTES — bf16-source mode windows
    bands too wide for the exact modes (cap ~63k rows vs ~31k at n=512)."""
    csr = artificial_matrix_generation(80000, 80000, 5, 1.7, "normal",
                                       seed=11, placement="diagonal",
                                       bw=0.5)
    assert DeviceGELL.from_csr(csr, mode="f32").win_plan is None
    ab = DeviceGELL.from_csr(csr, mode="bf16")
    assert ab.win_plan is not None, "bf16 cap should window a ~40k band"
    x = np.random.default_rng(4).standard_normal((80000, 16)) \
        .astype(np.float32)
    y = np.asarray(gell_spmm(ab, jnp.asarray(x)), np.float64)
    m = error_metrics(_gold(csr, x), y, epsilon=1e-4)
    assert m.mape < 5e-2, m.mape


def test_bsr_inapplicable_when_blocks_would_materialize_huge():
    """r4 regression: a scattered mid-density 137k-row matrix occupies
    ~nnz 128x128 blocks (~190GB dense) and the conversion wedged the
    host for 10 minutes before the cost-model gate existed.  The
    estimate must be inf for that shape and stay finite for banded
    matrices whose occupied blocks actually fit."""
    import math

    from spgrid.features.structural import matrix_features
    from spgrid.ops.costmodel import estimate_spmm_time

    scat = artificial_matrix_generation(
        40000, 40000, 20, 6.7, "normal", seed=14, placement="random",
        bw=0.6, avg_num_neighbours=0.05, cross_row_similarity=0.5)
    f = matrix_features(scat)
    import dataclasses
    f_big = dataclasses.replace(f, m=137518, n=137518, nnz=2886435)
    assert math.isinf(estimate_spmm_time(f_big, "bsr_pallas", 512))

    banded = artificial_matrix_generation(
        8192, 8192, 60, 20, "normal", seed=14, placement="diagonal",
        bw=0.02)
    assert math.isfinite(
        estimate_spmm_time(matrix_features(banded), "bsr_pallas", 512))


def test_gell_windowed_per_window_convert(monkeypatch):
    """r5 (VERDICT r4 item 7): above the resident-bytes budget the
    windowed bf16/split16 paths slice-and-convert per window block
    instead of materializing a full derived source (the cv_gell 1M-row
    OOM).  Forcing the budget to zero must give the same answers."""
    import spgrid.ops.gell as gell_mod
    # k must exceed the bf16 span cap (~64512 rows) so BOTH modes window
    csr = artificial_matrix_generation(80000, 80000, 5, 1.7, "normal",
                                       seed=11, placement="random", bw=0.05,
                                       skew=10)      # skew -> COO tail too
    x = np.random.default_rng(4).standard_normal((80000, 16)) \
        .astype(np.float32)
    outs = {}
    for mode in ("bf16", "split16"):
        a = DeviceGELL.from_csr(csr, mode=mode)
        assert a.win_plan is not None
        y_full = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
        monkeypatch.setattr(gell_mod, "_PER_WIN_CONVERT_BUDGET", 0)
        gell_mod._gell_spmm.clear_cache()
        y_pwc = np.asarray(gell_spmm(a, jnp.asarray(x)), np.float64)
        monkeypatch.setattr(gell_mod, "_PER_WIN_CONVERT_BUDGET", 6 << 30)
        gell_mod._gell_spmm.clear_cache()
        np.testing.assert_allclose(y_pwc, y_full, rtol=2e-4, atol=2e-4)
        m = error_metrics(_gold(csr, x), y_pwc, epsilon=1e-4)
        tol = 5e-2 if mode == "bf16" else 5e-4
        assert m.mape < tol, (mode, m.mape)
        outs[mode] = y_pwc
