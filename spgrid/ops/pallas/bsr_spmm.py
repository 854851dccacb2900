"""Block-sparse-row SpMM as a Pallas kernel on the Triton route.

The reference balances *rows* across cores (``spmv_kernel_csr.cpp:352-460``);
here the unit of work is a dense (bm, bk) block of DeviceBSR.  One program
owns one (row tile, n tile) of the output and walks its block row's blocks
through ``row_starts`` — a loop inside the program, so nothing carries over
between programs and they run in any order:

  for b in row_starts[r] .. row_starts[r+1]:
      acc[tm, tn] += blocks[b][rows of the tile, kc-chunk]
                     @ x[block_cols[b]*bk + kc-chunk, n tile]

Each X tile is loaded by block column straight from device memory; the XLA
form (ops/xla.py::spmm_bsr) instead gathers an (nb, bk, n) copy of X
through device memory first.  The (bm, bk) block is split into (tm, kc)
sub-tiles so one pipeline stage stays far inside a block's shared memory,
and Triton pipelines the loop's loads over ``num_stages``.

Ragged edges are masked loads and stores, not padded copies: rows of X past
k and columns past n read as zero, output rows past m are not written.  A
block row with no blocks runs the loop zero times and stores zeros.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from spgrid.core import platform
from spgrid.ops.layouts import DeviceBSR


def pow2_divisor(x: int, cap: int) -> int:
    """Largest power of two that divides x, at most cap."""
    p = 1
    while p * 2 <= cap and x % (p * 2) == 0:
        p *= 2
    return p


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def tile_product(a, b):
    """a (t, c) @ b (c, u) accumulated in f32 at full f32 precision.

    Triton's dot takes no dimension under 16; smaller tiles (bm = 8
    layouts) contract by broadcast-multiply-sum instead."""
    if min(a.shape[0], a.shape[1], b.shape[1]) >= 16:
        return pl.dot(a, b, precision=lax.Precision.HIGHEST)
    return jnp.sum(a.astype(jnp.float32)[:, :, None]
                   * b.astype(jnp.float32)[None, :, :], axis=1)


# Two waves of programs over the H100's 132 SMs: below this, smaller
# tiles buy parallelism (measured on the DLMC 512^2 twin, PERF.md).
MIN_PROGRAMS = 264


def spmm_tiles(mb: int, bm: int, bk: int, n: int) -> tuple:
    """(tm, kc, tn, num_warps): output rows, contraction chunk and output
    columns of one program step.  Powers of two (Triton's requirement)
    that divide the block.  Large grids take (64, 32, 128) tiles on 8
    warps, small ones (32, 32, 64) on 4 — the fastest of a tile sweep on
    a banded 16k^2 matrix and on the DLMC 512^2 twin (PERF.md)."""
    tm = pow2_divisor(bm, 64)
    kc = pow2_divisor(bk, 32)
    tn = min(128, max(16, next_pow2(n)))
    if tm < 16 or kc < 16:
        # broadcast-sum path: keep the (tm, kc, tn) product small
        return tm, min(kc, 8), min(tn, 64), 4
    if mb * (bm // tm) * pl.cdiv(n, tn) < MIN_PROGRAMS:
        tm, tn = min(tm, 32), min(tn, 64)
    return tm, kc, tn, (8 if tm * tn >= 64 * 128 else 4)


def _kernel(starts_ref, cols_ref, blocks_ref, x_ref, o_ref, *,
            bm, bk, tm, kc, tn, m, k, n):
    row_tiles = bm // tm
    i, j = pl.program_id(0), pl.program_id(1)
    r, sub = lax.div(i, row_tiles), lax.rem(i, row_tiles)
    start, end = starts_ref[r], starts_ref[r + 1]
    nk = bk // kc
    col0 = j * tn
    col_ok = (col0 + jnp.arange(tn)) < n

    def body(t, acc):
        # lax.div/rem: operands are non-negative, and jnp's floor
        # division does not lower inside a Triton loop
        b = start + lax.div(t, nk)
        kk = lax.rem(t, nk)
        a = blocks_ref[b, pl.ds(sub * tm, tm), pl.ds(kk * kc, kc)]
        row0 = cols_ref[b] * bk + kk * kc
        row_ok = (row0 + jnp.arange(kc)) < k
        x = pltr.load(x_ref.at[pl.ds(row0, kc), pl.ds(col0, tn)],
                      mask=row_ok[:, None] & col_ok[None, :], other=0)
        return acc + tile_product(a.astype(x.dtype), x)

    acc = lax.fori_loop(0, (end - start) * nk, body,
                        jnp.zeros((tm, tn), jnp.float32))
    out0 = r * bm + sub * tm
    out_ok = (out0 + jnp.arange(tm)) < m
    pltr.store(o_ref.at[pl.ds(out0, tm), pl.ds(col0, tn)],
               acc.astype(o_ref.dtype),
               mask=out_ok[:, None] & col_ok[None, :])


@functools.partial(jax.jit, static_argnames=("m",))
def bsr_spmm_starts(row_starts, block_cols, blocks, x, *, m):
    """Core call: Y (m, n) = A @ X with A given by block-row pointers.

    row_starts[r]..row_starts[r+1] index the blocks of block row r; blocks
    past row_starts[-1] (padding) are never read."""
    _, bm, bk = blocks.shape
    k, n = x.shape
    mb = row_starts.shape[0] - 1
    tm, kc, tn, num_warps = spmm_tiles(mb, bm, bk, n)
    kernel = functools.partial(_kernel, bm=bm, bk=bk, tm=tm, kc=kc, tn=tn,
                               m=m, k=k, n=n)
    return pl.pallas_call(
        kernel,
        grid=(mb * (bm // tm), pl.cdiv(n, tn)),
        in_specs=[pl.BlockSpec()] * 4,
        out_specs=pl.BlockSpec(),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        backend=platform.PALLAS_BACKEND,
        compiler_params=pltr.CompilerParams(num_warps=num_warps,
                                            num_stages=3),
        interpret=platform.interpret(),
        name="bsr_spmm",
    )(row_starts, block_cols, blocks, x)


def bsr_spmm(bsr: DeviceBSR, x: jax.Array) -> jax.Array:
    """Y = A @ X with A in DeviceBSR layout (any bm, bk; f32 or bf16)."""
    return bsr_spmm_starts(bsr.row_starts, bsr.block_cols, bsr.blocks, x,
                           m=bsr.shape[0])
