"""Row-partitioned distributed SpMM over a device mesh.

Y = A @ X with A's block rows sharded over the ``model`` mesh axis (each
device owns an equal row range, blocks nnz-padded to a common static shape)
and X either replicated or row-sharded with an all-gather as the
dense-operand halo exchange.  X's columns may additionally be sharded over
the ``data`` axis — that direction needs no communication at all.

This is the device-mesh answer to the reference's OpenMP row
partitioning (spmv_kernel_csr.cpp:352-373 + parallel_util.h) scaled past
one card (BASELINE.json: >=80% weak-scaling at 2+ hosts).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from spgrid.dist.partition import ShardedBSR
from spgrid.ops import xla as xops
from spgrid.ops.pallas.bsr_spmm import bsr_spmm_starts


def _local_spmm(rows, cols, blocks, x, mb_local, m_local, use_pallas):
    if use_pallas:
        # block rows are sorted, padding blocks (row = mb_local) last
        starts = jnp.searchsorted(rows, jnp.arange(mb_local + 1,
                                                   dtype=rows.dtype))
        return bsr_spmm_starts(starts.astype(jnp.int32), cols, blocks, x,
                               m=m_local)
    return xops._spmm_bsr(rows, cols, blocks, x, mb_local, m_local)


def make_dist_spmm(
    mesh: Mesh,
    sharded: ShardedBSR,
    *,
    model_axis: str = "model",
    data_axis: Optional[str] = "data",
    x_partition: str = "replicated",   # 'replicated' | 'row_sharded' | 'halo'
    use_pallas: bool = False,
):
    """Build a jitted distributed SpMM closure over ``sharded``.

    Returns ``f(x) -> y`` with x (k, n) and y (S*rows_per_shard, n); y's rows
    are sharded over ``model_axis`` and columns over ``data_axis``.
    """
    mb_local = sharded.rows_per_shard // sharded.bm
    m_local = sharded.rows_per_shard
    if x_partition == "halo" and not sharded.kb_per_shard:
        raise ValueError("x_partition='halo' needs partition_bsr_halo "
                         "(column-localized shards)")
    sharded_x = x_partition in ("row_sharded", "halo")
    S = mesh.shape[model_axis]

    xcols = P(data_axis) if data_axis else P()
    x_spec = P(model_axis, *xcols) if sharded_x else P(None, *xcols)
    bsr_specs = (P(model_axis), P(model_axis), P(model_axis))

    def local_fn(rows, cols, blocks, x):
        rows, cols, blocks = rows[0], cols[0], blocks[0]
        if x_partition == "halo":
            # Bandwidth-aware halo exchange: each shard fetches only the
            # halo_left/right neighbor x shards via ppermute rings —
            # O(halo) neighbor hops instead of the O(S) all_gather; the
            # matrix's bandwidth feature bounds the halo width.  Edge
            # shards receive wrapped segments their (rebased) block cols
            # never index.
            segs = []
            for d in range(sharded.halo_left, 0, -1):
                segs.append(jax.lax.ppermute(
                    x, model_axis, perm=[(j, (j + d) % S) for j in range(S)]))
            segs.append(x)
            for d in range(1, sharded.halo_right + 1):
                segs.append(jax.lax.ppermute(
                    x, model_axis, perm=[(j, (j - d) % S) for j in range(S)]))
            x = jnp.concatenate(segs, axis=0) if len(segs) > 1 else x
        elif x_partition == "row_sharded":
            # General-span fallback: gather the whole dense operand.
            x = jax.lax.all_gather(x, model_axis, axis=0, tiled=True)
        return _local_spmm(rows, cols, blocks, x, mb_local, m_local,
                           use_pallas)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(*bsr_specs, x_spec),
        out_specs=P(model_axis, *xcols),
        check_vma=False,
    )

    @jax.jit
    def run(x):
        if x_partition == "halo":
            # pad x rows so each shard owns exactly kb_per_shard*bk of them
            kps = sharded.kb_per_shard * sharded.bk
            need = S * kps
            if x.shape[0] < need:
                x = jnp.pad(x, ((0, need - x.shape[0]), (0, 0)))
        return fn(sharded.block_rows, sharded.block_cols, sharded.blocks, x)

    return run


def dist_bsr_spmm(mesh: Mesh, sharded: ShardedBSR, x: jax.Array,
                  **kw) -> jax.Array:
    """One-shot convenience wrapper; prefer make_dist_spmm for timing loops."""
    return make_dist_spmm(mesh, sharded, **kw)(x)
