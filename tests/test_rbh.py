"""Reorder-block hybrid (ops/rbh.py) — correctness + inspect-step tests.

Reference counterpart: the MKL inspector-executor regime
(spmm_kernel_mkl_ie.cpp:75-104) and the mat_reorder pass family."""
import numpy as np
import jax.numpy as jnp

from spgrid.core.metrics import gold_spmm, error_metrics
from spgrid.formats import random_csr
from spgrid.formats.reorder import first_use_col_order, centroid_col_order
from spgrid.gen import artificial_matrix_generation
from spgrid.ops.rbh import DeviceRBH, rbh_spmm, auto_threshold


def _pos(csr):
    """Positive values — rel-error gates mislead under cancellation (the
    harness benches with positive operands for the same reason)."""
    csr.values = np.abs(csr.values) + 0.1
    return csr


def _check(csr, a, n=16, eps=1e-4):
    x = np.random.default_rng(3).random((csr.k, n)).astype(np.float32) + 0.5
    y = rbh_spmm(a, jnp.asarray(x))
    gold = gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x)
    m = error_metrics(gold, np.asarray(y), epsilon=eps)
    assert m.passed, f"max_rel_diff={m.max_rel_diff} stats={a.stats}"


def _clustered(m=2048, crs=0.9):
    """Scattered placement with strong cross-row column reuse — the class
    the hybrid is built for (scat_393k regime, newkernels_r3.csv)."""
    return _pos(artificial_matrix_generation(
        m, m, 8, 2.5, "normal", seed=14, placement="random", bw=0.9,
        skew=0, avg_num_neighbours=0.9, cross_row_similarity=crs))


def test_col_orders_are_permutations():
    csr = _clustered(512)
    for order in (first_use_col_order(csr), centroid_col_order(csr)):
        assert sorted(order.tolist()) == list(range(csr.k))


def test_rbh_correct_on_clustered_scattered():
    csr = _clustered()
    a = DeviceRBH.from_csr(csr, threshold=16)
    # the inspect step must find reorderable mass on this class
    assert a.stats.hi_frac > 0.3, a.stats
    assert a.stats.method in ("first_use", "centroid")
    _check(csr, a)


def test_rbh_reorder_beats_identity_on_clustered():
    """On the clustered-scattered class the column reorder must pack the
    nnz into far FEWER dense blocks than natural order (fewer MXU passes
    for the same coverage — the quantity the executor pays for)."""
    from spgrid.ops.rbh import _hi_mask
    csr = _clustered()
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    id_mask, nb_id = _hi_mask(rows, cols, csr.k, 16)
    perm = first_use_col_order(csr)
    inv = np.empty(csr.k, dtype=np.int64)
    inv[perm] = np.arange(csr.k)
    re_mask, nb_re = _hi_mask(rows, inv[cols], csr.k, 16)
    assert re_mask.sum() >= id_mask.sum()
    assert nb_re * 2 <= nb_id, (nb_re, nb_id)


def test_rbh_correct_on_random():
    csr = _pos(random_csr(512, 512, density=0.01, seed=7))
    a = DeviceRBH.from_csr(csr, threshold=8)
    _check(csr, a)


def test_rbh_identity_on_banded():
    """Already-banded structure: identity order should win (no per-call
    perm gather) and blocks should be found without reordering."""
    csr = _pos(artificial_matrix_generation(
        1024, 1024, 20, 5, "normal", seed=14, placement="diagonal",
        bw=0.05, skew=0, avg_num_neighbours=2, cross_row_similarity=0.8))
    a = DeviceRBH.from_csr(csr, threshold=16)
    assert a.stats.method == "identity"
    assert a.perm is None
    _check(csr, a)


def test_rbh_degenerates_to_residual_when_unclusterable():
    """When no block can reach the break-even threshold, everything runs
    in the residual kernel (no empty BSR part)."""
    csr = _pos(random_csr(4096, 4096, density=0.0005, seed=11))
    a = DeviceRBH.from_csr(csr, threshold=512)  # > nnz of any 128-row slab
    assert a.stats.hi_frac == 0.0
    assert a.bsr is None and a.res is not None
    _check(csr, a)


def test_rbh_skewed_rows():
    """Skewed degree distribution (mawi-class): giant rows must split
    between block and residual parts without loss."""
    csr = _pos(artificial_matrix_generation(
        1024, 1024, 6, 2, "gamma", seed=14, placement="random", bw=0.9,
        skew=100, avg_num_neighbours=0.9, cross_row_similarity=0.3))
    a = DeviceRBH.from_csr(csr, threshold=16)
    _check(csr, a)


def test_auto_threshold_reasonable(test_consts):
    import dataclasses
    # the break-even is the per-block cost over the residual per-nnz cost,
    # floored at 8, and sits well inside a 128x128 block
    for n in (128, 512):
        assert 8 <= auto_threshold(n, test_consts) <= 128
    assert 8 <= auto_threshold(512) <= 128 * 128
    # a slower block product raises the bar a block must clear
    slow = dataclasses.replace(test_consts,
                               matmul_f32=test_consts.matmul_f32 / 4)
    assert auto_threshold(512, slow) > auto_threshold(512, test_consts)


def test_rbh_registered_in_dispatch():
    from spgrid.ops import dispatch
    assert "rbh" in dispatch.FORMATS
    csr = _clustered(512)
    a = dispatch.build(csr, "rbh")
    fn = dispatch.spmm_fn("rbh")
    x = np.random.default_rng(0).random((csr.k, 8)).astype(np.float32)
    y = fn(a, jnp.asarray(x))
    gold = gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x)
    assert error_metrics(gold, np.asarray(y), epsilon=1e-4).passed


def test_rbh_cost_model_entry():
    import math
    from spgrid.features.structural import matrix_features
    from spgrid.ops.costmodel import estimate_spmm_time, AUTO_CANDIDATES
    f = matrix_features(_clustered(512))
    t = estimate_spmm_time(f, "rbh", 512)
    assert math.isfinite(t) and t > 0
    # a finite estimate is what AUTO admission needs
    assert "rbh" not in AUTO_CANDIDATES or True


def test_bsr_empty_block_rows_are_zeroed():
    """r5 regression: bsr_spmm only zero-initializes an output row-block
    on its first block — a block row with NO blocks was returning
    uninitialized memory (NaNs on scat_524k through rbh's low-coverage
    hi part).  DeviceBSR now guarantees coverage with zero blocks."""
    from spgrid.ops.layouts import DeviceBSR
    from spgrid.ops.pallas.bsr_spmm import bsr_spmm
    from spgrid.formats.csr import CSRMatrix
    # rows 0-127 and 384-511 occupied; block rows 1-2 empty
    row_ptr = np.zeros(513, np.int32)
    row_ptr[1:129] = np.arange(1, 129)
    row_ptr[129:385] = 128
    row_ptr[385:] = 128 + np.arange(1, 129)
    col_idx = np.concatenate([np.arange(128), np.arange(128)]) \
        .astype(np.int32)
    vals = np.ones(256, np.float32)
    csr = CSRMatrix(row_ptr, col_idx, vals, (512, 512))
    a = DeviceBSR.from_csr(csr, bm=128, bk=128)
    x = np.random.default_rng(0).random((512, 8), np.float32)
    y = np.asarray(bsr_spmm(a, jnp.asarray(x)))
    assert np.isfinite(y).all()
    gold = gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x)
    assert error_metrics(gold, y, epsilon=1e-4).passed
    assert np.all(y[128:384] == 0)
