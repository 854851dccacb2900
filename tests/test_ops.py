import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spgrid.core.metrics import gold_spmm, error_metrics
from spgrid.formats import random_csr
from spgrid.gen import artificial_matrix_generation
from spgrid.ops import (
    DeviceCOO, DeviceELL, DeviceBSR, DeviceSELL,
    spmv_coo, spmm_coo, spmv_ell, spmm_ell, spmm_bsr, spmv_sell,
    spmm_dense, sddmm_coo, sddmm_dense, sddmm_bsr, bsr_spmm,
    select_format, autotune_spmm,
)


@pytest.fixture(scope="module")
def prob():
    csr = artificial_matrix_generation(300, 250, 8, 3, "normal", seed=14,
                                       placement="random", bw=0.3)
    rng = np.random.default_rng(0)
    x = rng.random((250, 64)).astype(np.float32) + 0.1
    gold = gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x)
    return csr, x, gold


def check(gold, test, eps=1e-4):
    m = error_metrics(gold, np.asarray(test), epsilon=eps)
    assert m.passed, f"max_rel_diff={m.max_rel_diff}"


def test_spmv_coo(prob):
    csr, x, _ = prob
    gold = gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x[:, 0])
    y = spmv_coo(DeviceCOO.from_csr(csr), jnp.asarray(x[:, 0]))
    check(gold, y)


def test_spmm_coo(prob):
    csr, x, gold = prob
    check(gold, spmm_coo(DeviceCOO.from_csr(csr), jnp.asarray(x)))


def test_spmv_ell(prob):
    csr, x, _ = prob
    gold = gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x[:, 0])
    check(gold, spmv_ell(DeviceELL.from_csr(csr), jnp.asarray(x[:, 0])))


def test_spmm_ell(prob):
    csr, x, gold = prob
    check(gold, spmm_ell(DeviceELL.from_csr(csr), jnp.asarray(x)))


def test_spmm_bsr_xla(prob):
    csr, x, gold = prob
    check(gold, spmm_bsr(DeviceBSR.from_csr(csr, bm=8, bk=32), jnp.asarray(x)))


def test_spmv_sell(prob):
    csr, x, _ = prob
    gold = gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x[:, 0])
    check(gold, spmv_sell(DeviceSELL.from_csr(csr), jnp.asarray(x[:, 0])))


def test_spmm_dense(prob):
    csr, x, gold = prob
    check(gold, spmm_dense(jnp.asarray(csr.to_dense()), jnp.asarray(x)))


def test_bsr_spmm_pallas(prob):
    csr, x, gold = prob
    bsr = DeviceBSR.from_csr(csr, bm=8, bk=128)
    check(gold, bsr_spmm(bsr, jnp.asarray(x)))


def test_bsr_spmm_pallas_wide_n(prob):
    csr, x, gold = prob
    # n not a multiple of the tile; bm=16
    bsr = DeviceBSR.from_csr(csr, bm=16, bk=128)
    x3 = np.concatenate([x, x[:, :33]], axis=1)
    gold3 = np.concatenate([gold, gold[:, :33]], axis=1)
    check(gold3, bsr_spmm(bsr, jnp.asarray(x3)))


def test_sddmm_coo():
    rng = np.random.default_rng(1)
    mask = random_csr(64, 64, density=0.2, seed=5)
    q = (rng.random((64, 32)).astype(np.float32) + 0.1)
    k = (rng.random((64, 32)).astype(np.float32) + 0.1)
    dmask = DeviceCOO.from_csr(mask)
    vals = np.asarray(sddmm_coo(dmask, jnp.asarray(q), jnp.asarray(k)))
    # gold: per nnz dot
    gold_dense = mask.to_dense() * (q.astype(np.float64) @ k.T.astype(np.float64))
    rows = np.asarray(dmask.rows)[: mask.nnz]
    cols = np.asarray(dmask.cols)[: mask.nnz]
    check(gold_dense[rows, cols], vals[: mask.nnz])


def test_bsr_sddmm_pallas():
    rng = np.random.default_rng(2)
    mask = random_csr(96, 96, density=0.15, seed=6)
    q = (rng.random((96, 48)).astype(np.float32) + 0.1)
    k = (rng.random((96, 48)).astype(np.float32) + 0.1)
    mbsr = DeviceBSR.from_csr(mask, bm=8, bk=128)
    # the pipeline's block SDDMM (the XLA form: the Triton kernel lost
    # its A/B on the H100 and was removed)
    out = np.asarray(sddmm_bsr(mbsr, jnp.asarray(q), jnp.asarray(k)))
    gold_dense = mask.to_dense().astype(np.float64) * (
        q.astype(np.float64) @ k.T.astype(np.float64))
    # reassemble dense from blocks
    got = np.zeros((mbsr.mb * 8, 128 * ((96 + 127) // 128)))
    br = np.asarray(mbsr.block_rows)
    bc = np.asarray(mbsr.block_cols)
    for b in range(mbsr.num_blocks):
        got[br[b] * 8:(br[b] + 1) * 8, bc[b] * 128:(bc[b] + 1) * 128] = out[b]
    check(gold_dense, got[:96, :96])


def test_select_format_rules(test_consts):
    from spgrid.features import matrix_features
    dense_f = matrix_features(random_csr(64, 64, density=0.5, seed=1))
    assert select_format(dense_f, consts=test_consts) == "dense"
    sparse_f = matrix_features(random_csr(2000, 2000, density=0.001, seed=1))
    # tiny hypersparse may still be cheap to densify; any of the gather
    # family or dense is a sane pick at this size
    assert select_format(sparse_f, consts=test_consts) in (
        "ell", "coo", "gell", "dense", "bsr_pallas")


def test_autotune_runs(prob):
    csr, x, _ = prob
    r = autotune_spmm(csr, jnp.asarray(x), candidates=("dense", "ell", "coo"),
                      min_time_s=0.01, min_iters=2)
    assert r.best in r.times
    assert np.isfinite(r.times[r.best])


def test_autotune_default_candidates_match_auto():
    """Measured dispatch must be able to pick every kernel cost-based
    dispatch can (a stale default once quietly excluded gell/merge/sell,
    the kernels of the hypersparse classes)."""
    import inspect
    from spgrid.ops.costmodel import AUTO_CANDIDATES
    from spgrid.ops.dispatch import autotune_spmm as at
    sig = inspect.signature(at)
    assert sig.parameters["candidates"].default is None  # -> AUTO_CANDIDATES
    csr = random_csr(256, 256, density=0.02, seed=3)
    x = jnp.asarray(np.random.default_rng(0).random((256, 8), np.float32))
    r = autotune_spmm(csr, x, min_time_s=0.01, min_iters=2)
    assert set(r.times) == set(AUTO_CANDIDATES)
    assert np.isfinite(r.times[r.best])


def test_autotune_skips_inapplicable_without_building():
    """A format the cost model marks +inf (dense blocks would materialize
    >2GB) is skipped, not timed."""
    from spgrid.ops.dispatch import autotune_spmm as at
    # hypersparse scattered: bsr occupancy ~ nnz -> gate fires
    csr = random_csr(4096, 300000, density=0.0001, seed=5)
    x = jnp.asarray(np.random.default_rng(1).random((300000, 4), np.float32))
    r = at(csr, x, candidates=("bsr_pallas", "coo"), min_time_s=0.01,
           min_iters=2)
    assert r.times["bsr_pallas"] == float("inf")
    assert r.best == "coo"
