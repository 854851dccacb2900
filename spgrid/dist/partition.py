"""nnz-balanced block-row partitioning of a BSR matrix across shards.

The distributed analogue of ``loop_partitioner_balance_prefix_sums``
(parallel_util.h:141-165): shard boundaries land on block rows so each
device receives ~equal stored blocks; per-shard arrays are padded to a
common static shape (sacrificial blocks with local row = mb_local) and
stacked on a leading device axis for ``shard_map``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.bsr import BSRMatrix, csr_to_bsr
from spgrid.formats.csr import CSRMatrix
from spgrid.formats.partition import balance_prefix_sums


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedBSR:
    """Stacked per-shard BSR arrays; leading axis = shard index.

    Every shard covers ``rows_per_shard`` logical rows (equal static output
    shard); block rows are *local* to the shard.  ``nnz`` is the true global
    nnz for flop accounting."""

    block_rows: jax.Array     # (S, nbs) int32, local block-row ids
    block_cols: jax.Array     # (S, nbs) int32, block-col ids (global, or
                              # halo-window-local when halo partitioned)
    blocks: jax.Array         # (S, nbs, bm, bk)
    shape: Tuple[int, int]
    rows_per_shard: int       # logical rows per shard (multiple of bm)
    nnz: int
    # halo partitioning (partition_bsr_halo): x block-cols owned per shard
    # and neighbor reach in whole shards per side; 0/0 + kb_per_shard=0
    # means cols are global (all_gather / replicated paths)
    halo_left: int = 0
    halo_right: int = 0
    kb_per_shard: int = 0

    def tree_flatten(self):
        return ((self.block_rows, self.block_cols, self.blocks),
                (self.shape, self.rows_per_shard, self.nnz,
                 self.halo_left, self.halo_right, self.kb_per_shard))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def num_shards(self) -> int:
        return self.blocks.shape[0]

    @property
    def bm(self) -> int:
        return self.blocks.shape[2]

    @property
    def bk(self) -> int:
        return self.blocks.shape[3]


def partition_bsr(csr: CSRMatrix, num_shards: int, bm: int = 8,
                  bk: int = 128) -> ShardedBSR:
    """Build the stacked shard arrays from a host CSR.

    Shards are *contiguous equal row ranges* (static output shapes demand
    equal rows/shard); the nnz imbalance that motivates the reference's
    prefix-sum balancer shows up instead as per-shard padding, reported by
    the caller via ``block fill``.  A future variant can permute rows by the
    balancer before sharding (sigma-sort style) to equalize blocks.
    """
    bsr = csr_to_bsr(csr, bm=bm, bk=bk)
    mb = bsr.mb
    mb_per_shard = -(-mb // num_shards)
    rows_per_shard = mb_per_shard * bm

    brp = bsr.block_row_ptr
    counts = []
    ranges = []
    for s in range(num_shards):
        b0 = min(s * mb_per_shard, mb)
        b1 = min(b0 + mb_per_shard, mb)
        lo, hi = int(brp[b0]), int(brp[b1])
        counts.append(hi - lo)
        ranges.append((b0, b1, lo, hi))
    nbs = max(max(counts), 1)

    S = num_shards
    rows = np.full((S, nbs), mb_per_shard, dtype=np.int32)  # sacrificial
    cols = np.zeros((S, nbs), dtype=np.int32)
    blocks = np.zeros((S, nbs, bm, bk), dtype=csr.values.dtype)
    brows_global = np.repeat(np.arange(mb, dtype=np.int32), np.diff(brp))
    for s, (b0, b1, lo, hi) in enumerate(ranges):
        c = hi - lo
        rows[s, :c] = brows_global[lo:hi] - b0
        cols[s, :c] = bsr.block_col_idx[lo:hi]
        blocks[s, :c] = bsr.blocks[lo:hi]

    return ShardedBSR(
        block_rows=jnp.asarray(rows),
        block_cols=jnp.asarray(cols),
        blocks=jnp.asarray(blocks),
        shape=csr.shape,
        rows_per_shard=rows_per_shard,
        nnz=csr.nnz,
    )


def partition_bsr_halo(csr: CSRMatrix, num_shards: int, bm: int = 8,
                       bk: int = 128) -> ShardedBSR:
    """Row-partition like partition_bsr, but also column-localize for a
    neighbor halo exchange.

    Each shard owns x rows [s*kps, (s+1)*kps); its blocks' column span
    determines how many whole neighbor shards of x it needs per side.  The
    global (halo_left, halo_right) are the max over shards — for banded
    matrices both are small (often 1), so the dense-operand exchange is
    O(halo) neighbor ppermutes instead of an O(S) all_gather
    (BASELINE.json: halo segments between neighbours; the bandwidth feature of the
    matrix literally predicts halo size, SURVEY §7 hard part 5).

    Block cols are rebased to the shard's halo window:
    ``local_col = global_col - (s - halo_left) * kb_per_shard``.
    """
    base = partition_bsr(csr, num_shards, bm=bm, bk=bk)
    S = num_shards
    kb = -(-csr.k // bk)
    kbps = -(-kb // S)
    cols = np.asarray(base.block_cols)
    rows = np.asarray(base.block_rows)
    mb_per_shard = base.rows_per_shard // bm
    hl = hr = 0
    for s in range(S):
        real = rows[s] < mb_per_shard
        if not real.any():
            continue
        cmin, cmax = int(cols[s][real].min()), int(cols[s][real].max())
        hl = max(hl, -(-(s * kbps - cmin) // kbps)) if cmin < s * kbps else hl
        if cmax >= (s + 1) * kbps:
            hr = max(hr, -(-(cmax + 1 - (s + 1) * kbps) // kbps))
    hl, hr = max(hl, 0), max(hr, 0)
    local = cols - (np.arange(S)[:, None] - hl) * kbps
    # sacrificial (padding) blocks keep col 0 of the window
    local = np.where(rows < mb_per_shard, local, 0).astype(np.int32)
    assert local.min() >= 0 and local.max() < (hl + 1 + hr) * kbps
    return ShardedBSR(
        block_rows=base.block_rows,
        block_cols=jnp.asarray(local),
        blocks=base.blocks,
        shape=base.shape,
        rows_per_shard=base.rows_per_shard,
        nnz=base.nnz,
        halo_left=hl,
        halo_right=hr,
        kb_per_shard=kbps,
    )
