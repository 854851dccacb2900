"""Distributed sparse-attention pipeline over a (data, model) mesh.

Sharding layout (the "training step" shape of this framework):
  - X (k, n): columns sharded over ``data`` (pure DP — zero communication),
    replicated over ``model``.
  - W_K/W_Q/W_V and the mask: block rows sharded over ``model`` (TP/SP
    analogue — each device owns a contiguous row range of the sequence).
  - K/Q/V = W @ X: computed locally, rows live on their model shard.
  - SDDMM S = mask ⊙ (Q Kᵀ): Q rows are local; K is all-gathered over the
    model axis (the long-context halo of SURVEY §5).
  - Y = S @ V: V all-gathered likewise; output rows stay model-sharded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from spgrid.formats.csr import CSRMatrix
from spgrid.dist.partition import ShardedBSR, partition_bsr
from spgrid.dist.spmm import _local_spmm
from spgrid.ops import xla as xops


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DistSparseAttention:
    wk: ShardedBSR
    wq: ShardedBSR
    wv: ShardedBSR
    mask: ShardedBSR

    def tree_flatten(self):
        return (self.wk, self.wq, self.wv, self.mask), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_csr(cls, wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                 mask: CSRMatrix, num_shards: int, bm: int = 8,
                 bk: int = 128) -> "DistSparseAttention":
        return cls(
            wk=partition_bsr(wk, num_shards, bm=bm, bk=bk),
            wq=partition_bsr(wq, num_shards, bm=bm, bk=bk),
            wv=partition_bsr(wv, num_shards, bm=bm, bk=bk),
            mask=partition_bsr(mask, num_shards, bm=bm, bk=bk),
        )

    @property
    def flops_per_col(self) -> float:
        return 2.0 * (self.wk.nnz + self.wq.nnz + self.wv.nnz
                      + 2 * self.mask.nnz)


def make_dist_pipeline_step(
    mesh: Mesh,
    attn: DistSparseAttention,
    *,
    model_axis: str = "model",
    data_axis: Optional[str] = "data",
    use_pallas: bool = False,
):
    """Jitted distributed pipeline step: x (k, n) -> y (m_padded, n)."""
    w_mb = attn.wk.rows_per_shard // attn.wk.bm
    w_m = attn.wk.rows_per_shard
    mk_mb = attn.mask.rows_per_shard // attn.mask.bm
    mk_m = attn.mask.rows_per_shard

    xcols = P(data_axis) if data_axis else P()
    wspec = (P(model_axis),) * 3

    def local_fn(wkr, wkc, wkb, wqr, wqc, wqb, wvr, wvc, wvb,
                 mr, mc, mb_, x):
        wkr, wkc, wkb = wkr[0], wkc[0], wkb[0]
        wqr, wqc, wqb = wqr[0], wqc[0], wqb[0]
        wvr, wvc, wvb = wvr[0], wvc[0], wvb[0]
        mr, mc, mb_blocks = mr[0], mc[0], mb_[0]

        k_loc = _local_spmm(wkr, wkc, wkb, x, w_mb, w_m, use_pallas)
        q_loc = _local_spmm(wqr, wqc, wqb, x, w_mb, w_m, use_pallas)
        v_loc = _local_spmm(wvr, wvc, wvb, x, w_mb, w_m, use_pallas)

        # Halo: sequence rows of K and V gathered across the model axis.
        k_full = jax.lax.all_gather(k_loc, model_axis, axis=0, tiled=True)
        v_full = jax.lax.all_gather(v_loc, model_axis, axis=0, tiled=True)

        s_blocks = xops._sddmm_bsr(mr, mc, mb_blocks, q_loc, k_full)
        if data_axis is not None:
            # The SDDMM contraction dim is the dense width n, which is
            # data-sharded: each data shard holds a partial dot — reduce
            # across the data axis (row-parallel contraction, Megatron-style).
            s_blocks = jax.lax.psum(s_blocks, data_axis)
        s_blocks = s_blocks.astype(x.dtype)
        y_loc = _local_spmm(mr, mc, s_blocks, v_full, mk_mb, mk_m,
                            use_pallas)
        return y_loc

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(*wspec, *wspec, *wspec, *wspec, P(None, *xcols)),
        out_specs=P(model_axis, *xcols),
        check_vma=False,
    )

    @jax.jit
    def step(x):
        a = attn
        return fn(a.wk.block_rows, a.wk.block_cols, a.wk.blocks,
                  a.wq.block_rows, a.wq.block_cols, a.wq.blocks,
                  a.wv.block_rows, a.wv.block_cols, a.wv.blocks,
                  a.mask.block_rows, a.mask.block_cols, a.mask.blocks,
                  x)

    return step
