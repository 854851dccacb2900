import numpy as np
import pytest
import jax.numpy as jnp

from spgrid.core.metrics import error_metrics
from spgrid.formats import random_csr
from spgrid.gen import create_mask
from spgrid.ops import (
    SparseAttention, attention_pipeline, make_pipeline_step, gold_pipeline,
)


@pytest.fixture(scope="module")
def problem():
    m = 128   # sequence/weight dim
    k = 96    # input dim
    n = 64    # dense width
    def pos(csr):
        # positive values avoid f32 cancellation noise vs the float64 gold
        # (the reference fills dense operands with 0.1: sddmm_bench.cpp:924-930)
        from spgrid.formats import CSRMatrix
        return CSRMatrix(csr.row_ptr, csr.col_idx,
                         np.abs(csr.values) + 0.1, csr.shape, csr.name)

    wk = pos(random_csr(m, k, density=0.5, seed=1))
    wq = pos(random_csr(m, k, density=0.5, seed=2))
    wv = pos(random_csr(m, k, density=0.5, seed=3))
    mask = create_mask("band_and_random", m, sparsity=0.8, band_size=4, seed=14)
    rng = np.random.default_rng(0)
    x = (rng.random((k, n)).astype(np.float32) * 0.2)
    return wk, wq, wv, mask, x


def check(gold, test, eps=5e-4):
    m = error_metrics(gold, np.asarray(test), epsilon=eps)
    assert m.passed, f"max_rel_diff={m.max_rel_diff}"


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pipeline_matches_gold(problem, use_pallas):
    wk, wq, wv, mask, x = problem
    attn = SparseAttention.from_csr(wk, wq, wv, mask, bm=8, bk=128,
                                    mask_bm=8, mask_bk=128)
    y, stages = attention_pipeline(attn, jnp.asarray(x),
                                   use_pallas=use_pallas)
    gold = gold_pipeline(wk, wq, wv, mask, x)
    check(gold, y)
    assert set(stages) == {"K", "Q", "V", "S", "Y"}


def test_pipeline_softmax(problem):
    wk, wq, wv, mask, x = problem
    attn = SparseAttention.from_csr(wk, wq, wv, mask, bm=8, bk=128,
                                    mask_bm=8, mask_bk=128)
    y, _ = attention_pipeline(attn, jnp.asarray(x), use_pallas=False,
                              softmax=True)
    gold = gold_pipeline(wk, wq, wv, mask, x, softmax=True)
    check(gold, y, eps=1e-3)
    # softmax rows of the gold S sum to 1 — sanity on scale
    assert np.abs(np.asarray(y)).max() < np.abs(
        gold_pipeline(wk, wq, wv, mask, x, softmax=False)).max()


def test_pipeline_step_jit(problem):
    wk, wq, wv, mask, x = problem
    attn = SparseAttention.from_csr(wk, wq, wv, mask)
    step = make_pipeline_step(attn, use_pallas=True)
    y1 = step(jnp.asarray(x))
    y2 = step(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    gold = gold_pipeline(wk, wq, wv, mask, x)
    check(gold, y1)


def test_flop_model(problem):
    wk, wq, wv, mask, x = problem
    attn = SparseAttention.from_csr(wk, wq, wv, mask)
    expected = 2.0 * (wk.nnz + wq.nnz + wv.nnz + 2 * mask.nnz)
    assert attn.flops_per_col == expected


def test_sddmm_occupancy_plan():
    """r3: occupancy planner — reachable-block denominator + inherence."""
    from spgrid.ops.sddmm_plan import (
        block_occupancy, choose_sddmm_blocks, occupancy_report,
        reachable_blocks,
    )
    from spgrid.gen.masks import create_mask

    L = 512
    # full causal reach at band 0: lower-triangle blocks of a 4x4 grid
    # (bm=bk=128) = 10 of 16
    assert reachable_blocks(L, 128, 128, 1) == 10

    # band half-width 12 at (512, 0.9): its super-diagonal strip adds the
    # 3 first-upper blocks to the 10 causal ones
    mask = create_mask("band_and_random", L, 0.9, band_size=None, seed=3)
    occ, tot = block_occupancy(mask, 128, 128)
    assert tot == 16 and occ <= reachable_blocks(L, 128, 128, 12)
    plan = choose_sddmm_blocks(mask, 512)
    assert plan.occupied <= plan.total
    assert plan.est_time_s <= plan.est_time_128 + 1e-12

    rows = occupancy_report(L, sparsities=(0.9,),
                            mask_types=("band_and_random",))
    r = rows[0]
    assert r["reachable_128"] == reachable_blocks(L, 128, 128, 12)
    assert 0.0 < r["occupancy_reachable"] <= 1.0
    assert r["inherent"] == (r["occupancy_reachable"] >= 0.95)
