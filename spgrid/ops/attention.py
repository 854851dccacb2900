"""Sparse-attention pipeline: K/Q/V weight SpMM → masked SDDMM → final SpMM.

Rebuilds the flagship benchmark of the reference
(``pipeline_code_bench/sddmm_bench.cpp:531-1159``): pruned-transformer weight
matrices W_K/W_Q/W_V (DLMC CSRs) multiply a dense activation X, the masked
attention scores are a block-sparse SDDMM of the K/Q results, and the final
SpMM applies the mask-shaped score matrix to V.  Per-stage results are
exposed for the per-stage timers the reference reports
(sddmm_bench.cpp:918-937), plus a single fused jitted step for the headline
number.

Softmax between SDDMM and the final SpMM exists but is disabled by default,
matching the reference (sddmm_bench.cpp:279, sddmm_taco_naive.cpp:215); when
enabled it is a block-sparse row softmax over mask nonzeros.
"""

from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.csr import CSRMatrix
from spgrid.ops.layouts import DeviceBSR
from spgrid.ops import xla as xops
from spgrid.ops.pallas.bsr_spmm import bsr_spmm


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SparseAttention:
    """Device-resident pipeline operands: three weight BSRs + the mask BSR."""

    wk: DeviceBSR
    wq: DeviceBSR
    wv: DeviceBSR
    mask: DeviceBSR

    def tree_flatten(self):
        return (self.wk, self.wq, self.wv, self.mask), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_csr(cls, wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                 mask: CSRMatrix, bm: int = 128, bk: int = 128,
                 mask_bm: int = 128, mask_bk: int = 128) -> "SparseAttention":
        return cls(
            wk=DeviceBSR.from_csr(wk, bm=bm, bk=bk),
            wq=DeviceBSR.from_csr(wq, bm=bm, bk=bk),
            wv=DeviceBSR.from_csr(wv, bm=bm, bk=bk),
            mask=DeviceBSR.from_csr(mask, bm=mask_bm, bk=mask_bk),
        )

    @property
    def flops_per_col(self) -> float:
        """Pipeline flop model: 2*(nnz_K+nnz_Q+nnz_V+2*nnz_mask)*n
        (pipeline_code_bench/sddmm_bench.cpp:983), divided by n."""
        return 2.0 * (self.wk.nnz + self.wq.nnz + self.wv.nnz
                      + 2 * self.mask.nnz)


def blocksparse_softmax(mask: DeviceBSR, s_blocks: jax.Array) -> jax.Array:
    """Row softmax over mask nonzeros, on block values.

    Padding blocks (block_row == mb) fold into segment mb and are sliced off.
    Positions that are mask zeros inside stored blocks are excluded via the
    mask block values.
    """
    mb = mask.mb
    valid = mask.blocks != 0
    neg = jnp.asarray(-jnp.inf, dtype=s_blocks.dtype)
    s_masked = jnp.where(valid, s_blocks, neg)
    # per (block, row-in-block) max → segment max over block rows
    blk_max = jnp.max(s_masked, axis=2)                       # (nb, bm)
    row_max = jax.ops.segment_max(blk_max, mask.block_rows,
                                  num_segments=mb + 1)        # (mb+1, bm)
    row_max = jnp.maximum(row_max, -1e30)
    g_max = jnp.take(row_max, mask.block_rows, axis=0)        # (nb, bm)
    e = jnp.where(valid, jnp.exp(s_blocks - g_max[:, :, None]), 0.0)
    blk_sum = jnp.sum(e, axis=2)
    row_sum = jax.ops.segment_sum(blk_sum, mask.block_rows,
                                  num_segments=mb + 1)
    g_sum = jnp.take(row_sum, mask.block_rows, axis=0)
    return (e / jnp.maximum(g_sum, 1e-30)[:, :, None]).astype(s_blocks.dtype)


def _with_blocks(bsr: DeviceBSR, blocks: jax.Array) -> DeviceBSR:
    return DeviceBSR(bsr.block_rows, bsr.block_cols, bsr.row_starts, blocks,
                     bsr.shape, bsr.nnz, bsr.num_blocks)


def attention_pipeline(
    attn: SparseAttention,
    x: jax.Array,
    *,
    use_pallas: bool = True,
    softmax: bool = False,
):
    """Run the 5-stage pipeline; returns (y, stages dict).

    Stage semantics mirror sddmm_bench.cpp:918-937:
      K = W_K @ X ; Q = W_Q @ X ; V = W_V @ X          (3x weight SpMM)
      S = mask ⊙ (Q @ K^T)                              (SDDMM)
      Y = S @ V                                         (final SpMM)
    """
    spmm = bsr_spmm if use_pallas else xops.spmm_bsr
    k = spmm(attn.wk, x)
    q = spmm(attn.wq, x)
    v = spmm(attn.wv, x)
    s_blocks = xops.sddmm_bsr(attn.mask, q, k)
    if softmax:
        s_blocks = blocksparse_softmax(attn.mask, s_blocks)
    s = _with_blocks(attn.mask, s_blocks.astype(x.dtype))
    y = spmm(s, v)
    return y, {"K": k, "Q": q, "V": v, "S": s_blocks, "Y": y}


def make_pipeline_step(attn: SparseAttention, *, use_pallas: bool = True,
                       softmax: bool = False):
    """A single jitted X -> Y pipeline callable (the headline benchmark)."""

    @jax.jit
    def step(x):
        y, _ = attention_pipeline(attn, x, use_pallas=use_pallas,
                                  softmax=softmax)
        return y

    return step


def gold_pipeline(wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                  mask: CSRMatrix, x: np.ndarray,
                  softmax: bool = False) -> np.ndarray:
    """float64 host oracle of the full 5-stage chain — the analogue of the
    reference's quad-precision gold pipeline (sddmm_bench.cpp:186-340)."""
    x64 = np.asarray(x, dtype=np.float64)
    k = wk.astype(np.float64).to_dense() @ x64
    q = wq.astype(np.float64).to_dense() @ x64
    v = wv.astype(np.float64).to_dense() @ x64
    md = mask.astype(np.float64).to_dense()
    s = md * (q @ k.T)
    if softmax:
        neg = np.where(md != 0, s, -np.inf)
        mx = np.max(neg, axis=1, keepdims=True)
        mx = np.where(np.isfinite(mx), mx, 0.0)
        e = np.where(md != 0, np.exp(s - mx), 0.0)
        s = e / np.maximum(e.sum(axis=1, keepdims=True), 1e-30)
    return s @ v
