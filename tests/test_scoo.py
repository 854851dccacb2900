"""Column-windowed COO SpMM (ops/scoo.py) — the scattered-hypersparse
kernel (re-designs the regime of spmm_kernel_mkl_ie.cpp:75-104)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spgrid.core.metrics import gold_spmm_fast
from spgrid.gen.artificial import artificial_matrix_generation
from spgrid.ops.scoo import DeviceSCOO, scoo_spmm
from spgrid.ops import dispatch


def _gen(m, avg, bw, seed=3):
    return artificial_matrix_generation(m, m, avg, 1.5, "normal", seed=seed,
                                        placement="random", bw=bw)


def _check(csr, n=64, **kw):
    a = DeviceSCOO.from_csr(csr, **kw)
    x = np.random.default_rng(0).random((csr.k, n)).astype(np.float32)
    y = np.asarray(scoo_spmm(a, jnp.asarray(x)))
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    np.testing.assert_allclose(y, gold, rtol=2e-5, atol=1e-4)
    return a


def test_scattered_multiblock():
    a = _check(_gen(5000, 6, 0.9), chunk_rows=1024, window_cols=1024)
    nb, ns, R, W, E = a.plan
    assert nb > 1 and ns > 1          # genuinely two-level


def test_banded():
    _check(_gen(3000, 4, 0.05), chunk_rows=1024, window_cols=1024)


def test_non_multiple_shapes():
    # m, k not multiples of the block sizes; sacrificial row absorbs pads
    _check(_gen(1337, 3, 1.0), chunk_rows=512, window_cols=512)


def test_spmv_vector_operand():
    csr = _gen(2000, 5, 0.8)
    a = DeviceSCOO.from_csr(csr, chunk_rows=512, window_cols=512)
    x = np.random.default_rng(1).random(csr.k).astype(np.float32)
    y = np.asarray(scoo_spmm(a, jnp.asarray(x)))
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x[:, None])
    np.testing.assert_allclose(y, gold[:, 0], rtol=2e-5, atol=1e-4)


def test_skew_two_tier_spill():
    # one heavy row (mawi-class skew): the per-block slot cap E must NOT
    # inflate to the heavy block's population — overflow spills to the
    # COO tail and the result still matches gold
    m = 8192
    csr = _gen(m, 3, 0.9, seed=7)
    rng = np.random.default_rng(9)
    heavy_cols = np.unique(rng.integers(0, m, 8000))       # ~half-dense row
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    rows = np.concatenate([rows, np.zeros(heavy_cols.size, np.int64)])
    cols = np.concatenate([csr.col_idx.astype(np.int64), heavy_cols])
    vals = np.concatenate([csr.values,
                           rng.random(heavy_cols.size).astype(np.float32)])
    order = np.lexsort((cols, rows))
    from spgrid.formats.csr import CSRMatrix
    rp = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=rp[1:])
    skewed = CSRMatrix(rp, cols[order].astype(np.int32),
                       vals[order], (m, m), name="skew_test")
    a = DeviceSCOO.from_csr(skewed, chunk_rows=256, window_cols=256)
    nb, ns, R, W, E = a.plan
    # mean block population ~30; the heavy row alone puts ~200 entries in
    # each of its chunk's 32 blocks — a global-max E would be >200
    assert E < 128, f"two-tier cap failed: E={E}"
    assert int(a.srows.size) > 0          # spill actually exercised
    x = np.random.default_rng(0).random((m, 32)).astype(np.float32)
    y = np.asarray(scoo_spmm(a, jnp.asarray(x)))
    gold = gold_spmm_fast(skewed.row_ptr, skewed.col_idx, skewed.values, x)
    np.testing.assert_allclose(y, gold, rtol=2e-5, atol=1e-4)


def test_dispatch_registered():
    csr = _gen(1000, 4, 0.9)
    a = dispatch.build(csr, "scoo")
    fn = dispatch.spmm_fn("scoo")
    x = np.random.default_rng(0).random((csr.k, 16)).astype(np.float32)
    y = np.asarray(fn(a, jnp.asarray(x)))
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    np.testing.assert_allclose(y, gold, rtol=2e-5, atol=1e-4)


def test_costmodel_has_entry():
    from spgrid.features.structural import matrix_features
    from spgrid.ops.costmodel import estimate_spmm_time, AUTO_CANDIDATES
    f = matrix_features(_gen(2000, 5, 0.9))
    t = estimate_spmm_time(f, "scoo", 512)
    assert np.isfinite(t) and t > 0
    # stays out of AUTO until a measurement fits its constant
    assert "scoo" not in AUTO_CANDIDATES
