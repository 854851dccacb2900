"""The Triton-route block SpMM (interpret mode on the CPU), its tile
choice and lowering to Triton IR for the GPU; and the XLA block SDDMM
that the pipeline runs (the Triton SDDMM lost its A/B, PERF.md)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spgrid.core import platform
from spgrid.formats import CSRMatrix, random_csr
from spgrid.ops.layouts import DeviceBSR
from spgrid.ops import xla as xops
from spgrid.ops.pallas.bsr_spmm import bsr_spmm, bsr_spmm_starts, spmm_tiles
from spgrid.ops.sddmm_plan import CANDIDATES

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _ragged_csr(m, k, seed, empty_rows):
    """Random positive matrix with whole block rows emptied."""
    csr = random_csr(m, k, 0.08, seed=seed)
    d = np.abs(csr.to_dense()) + 0.0
    d[d != 0] += 0.1
    for r0, r1 in empty_rows:
        d[r0:r1] = 0.0
    rows, cols = np.nonzero(d)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))])
    return CSRMatrix(row_ptr.astype(np.int32), cols.astype(np.int32),
                     d[rows, cols].astype(np.float32), (m, k))


@pytest.mark.parametrize("bm", [8, 128])
@pytest.mark.parametrize("n", [1, 96, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_spmm_interpret(dtype, n, bm):
    # ragged m and k (not block multiples) and empty block rows
    m, k = 300, 270
    csr = _ragged_csr(m, k, seed=3, empty_rows=[(128, 256)])
    dt = jnp.dtype(dtype)
    a = DeviceBSR.from_csr(csr.astype(dt), bm=bm, bk=128)
    x = np.random.default_rng(0).random((k, n)).astype(np.float32) + 0.5
    xq = np.asarray(jnp.asarray(x, dt).astype(jnp.float32), np.float64)
    aq = np.asarray(jnp.asarray(csr.to_dense(), dt).astype(jnp.float32),
                    np.float64)
    y = bsr_spmm(a, jnp.asarray(x, dt))
    assert y.shape == (m, n) and y.dtype == dt
    gold = aq @ xq
    y = np.asarray(y.astype(jnp.float32), np.float64)
    assert np.abs(y - gold).max() / np.abs(gold).max() < TOL[dtype]
    assert np.all(y[128:256] == 0)


@pytest.mark.parametrize("bm,bk", CANDIDATES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_sddmm_blocks(dtype, bm, bk):
    L, d = 300, 40               # ragged length and width
    mask = random_csr(L, L, 0.05, seed=6)
    dt = jnp.dtype(dtype)
    rng = np.random.default_rng(2)
    q = rng.random((L, d)).astype(np.float32)
    k = rng.random((L, d)).astype(np.float32)
    mb = DeviceBSR.from_csr(mask, bm=bm, bk=bk, pad_multiple=4)
    out = xops._sddmm_bsr(mb.block_rows, mb.block_cols,
                          mb.blocks.astype(dt), jnp.asarray(q, dt),
                          jnp.asarray(k, dt))
    assert out.shape == mb.blocks.shape and out.dtype == dt
    out = np.asarray(out.astype(jnp.float32), np.float64)
    qq = np.asarray(jnp.asarray(q, dt).astype(jnp.float32), np.float64)
    kq = np.asarray(jnp.asarray(k, dt).astype(jnp.float32), np.float64)
    gold = mask.to_dense() * (qq @ kq.T)
    got = np.zeros(((mb.mb + 1) * bm, -(-L // bk) * bk))
    br, bc = np.asarray(mb.block_rows), np.asarray(mb.block_cols)
    for b in range(out.shape[0]):
        got[br[b] * bm:(br[b] + 1) * bm, bc[b] * bk:(bc[b] + 1) * bk] += out[b]
    assert np.abs(got[:L, :L] - gold).max() / np.abs(gold).max() < TOL[dtype]
    # padding blocks (block_row = mb) come out zero
    assert np.all(out[mb.num_blocks:] == 0)


@pytest.mark.parametrize("mb,bm,bk,n,want", [
    (4, 128, 128, 512, (32, 32, 64, 4)),        # small grid: parallelism
    (128, 128, 128, 512, (64, 32, 128, 8)),     # large grid: big tiles
    (40, 8, 128, 64, (8, 8, 64, 4)),            # bm = 8: broadcast path
])
def test_spmm_tiles(mb, bm, bk, n, want):
    assert spmm_tiles(mb, bm, bk, n) == want


def _lower_for_gpu(monkeypatch, fn, *args, **kw):
    """Lower to the CUDA platform from the CPU: runs the Pallas Triton
    lowering (no GPU needed to build Triton IR)."""
    monkeypatch.setattr(platform, "interpret", lambda: False)
    return jax.jit(fn, static_argnames=tuple(kw)).trace(*args, **kw) \
        .lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_spmm_lowers_to_triton(monkeypatch, dtype):
    S = jax.ShapeDtypeStruct
    mb, nb, bm, k, n = 37, 301, 128, 4733, 512      # shapes unused elsewhere
    txt = _lower_for_gpu(
        monkeypatch, bsr_spmm_starts.__wrapped__, S((mb + 1,), jnp.int32),
        S((nb,), jnp.int32), S((nb, bm, 128), dtype), S((k, n), dtype),
        m=mb * bm - 5)
    assert "xla.gpu.triton" in txt and 'name = "bsr_spmm"' in txt


def test_kernel_on_gpu(gpu):
    """The compiled kernel against the XLA form on the card."""
    csr = random_csr(1024, 1024, 0.05, seed=2)
    a = DeviceBSR.from_csr(csr, bm=128, bk=128)
    x = jnp.asarray(np.random.default_rng(0).random((1024, 512), np.float32))
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(np.asarray(bsr_spmm(a, x)),
                                   np.asarray(xops.spmm_bsr(a, x)),
                                   rtol=1e-4, atol=1e-4)
