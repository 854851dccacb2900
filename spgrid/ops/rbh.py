"""Reorder-block hybrid (RBH): column-cluster reordering into dense block tiles.

Re-designs the locality lever behind the reference's MKL inspector-executor
SpMM (spmm_kernel_mkl_ie.cpp:75-104, mkl_sparse_optimize): on CPU the
inspector reorganizes the matrix once so the executor rides 256MB of L3
(105-328 GFLOPS on the scircuit/mac_econ class, amd-64/n=512/mkl_ie_f.csv).
A device's caches are far smaller than that working set; its equivalent
lever is STRUCTURE REUSE.  The scattered-hypersparse class has high cross_row_similarity /
avg_num_neighbours — columns are reused by runs of adjacent rows — so a
one-time COLUMN permutation (first-use or centroid order,
formats/reorder.py) concentrates each 128-row block's nnz into a few
128-col windows.  Blocks that come out dense enough run on the block
kernel (ops/pallas/bsr_spmm.py); the unclusterable tail falls back to a
gather kernel chosen by the cost model (sell, merge or coo).

The inspect step (ordering choice + block split) runs ONCE on the host,
like mkl_sparse_optimize.  The per-call price of the permutation — one X
row-gather xp = x[perm] — is part of the jitted kernel, so measured rows
include it; `split_stats` records the split so the analysis can state the
amortization and the reorderable fraction honestly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.csr import CSRMatrix, COOMatrix, coo_to_csr
from spgrid.formats.reorder import centroid_col_order, first_use_col_order
from spgrid.ops.layouts import DeviceBSR, DeviceSELL
from spgrid.ops.pallas.bsr_spmm import bsr_spmm
from spgrid.ops import xla as xops

BLOCK = 128
# dense-block byte budget: same 2GB wall as the bsr applicability gate
# (costmodel.estimate_spmm_time) — the hybrid never densifies past it
MAX_HI_BLOCKS = (2 << 30) // (BLOCK * BLOCK * 4)


def auto_threshold(n: int = 512, consts=None) -> int:
    """Break-even nnz per 128x128 block: below it the gather residual is
    cheaper than a full dense block pass (both priced with the card's
    constants, costmodel.C unless ``consts`` is given)."""
    from spgrid.ops.costmodel import C, residual_per_nnz
    c = consts or C
    per_block = max(BLOCK * n * 4 / c.eff_bw,
                    2.0 * BLOCK * BLOCK * n / c.matmul_f32)
    return max(8, int(per_block / residual_per_nnz(n, c)))


def _block_counts(rows: np.ndarray, cols_new: np.ndarray, k: int):
    """Per occupied 128x128 block nnz counts (keys, inverse, counts)."""
    kb = (k + BLOCK - 1) // BLOCK
    key = (rows.astype(np.int64) // BLOCK) * kb + (cols_new // BLOCK)
    return np.unique(key, return_inverse=True, return_counts=True)


def _hi_mask(rows, cols_new, k, thresh: int) -> Tuple[np.ndarray, int]:
    """Boolean per-nnz mask of entries in dense-enough blocks + block count,
    honoring the 2GB densification budget (densest blocks kept first)."""
    _, inv, cnt = _block_counts(rows, cols_new, k)
    keep = cnt >= thresh
    nb = int(keep.sum())
    if nb > MAX_HI_BLOCKS:
        order = np.argsort(-cnt)[:MAX_HI_BLOCKS]
        keep = np.zeros(len(cnt), dtype=bool)
        keep[order] = True
        keep &= cnt >= thresh
        nb = int(keep.sum())
    return keep[inv], nb


@dataclasses.dataclass
class SplitStats:
    """Inspect-step record (printed by the experiment scripts)."""

    method: str           # "identity" | "first_use" | "centroid"
    threshold: int
    hi_nnz: int
    lo_nnz: int
    hi_blocks: int
    hi_fill: float        # mean nnz / (128*128) over kept blocks
    hi_frac: float        # hi_nnz / nnz — the reorderable fraction

    def as_dict(self):
        return dataclasses.asdict(self)


@jax.tree_util.register_pytree_node_class
class DeviceRBH:
    """Device operand of the hybrid: optional column perm + dense-block
    part (DeviceBSR) + residual part (gather kernel operand)."""

    def __init__(self, perm, bsr, res, res_fmt, shape, nnz, stats, name):
        self.perm = perm            # (k,) int32 on device, or None
        self.bsr = bsr              # DeviceBSR or None
        self.res = res              # residual operand or None
        self.res_fmt = res_fmt      # "sell" | "coo"
        self.shape = shape
        self.nnz = nnz
        self.stats = stats
        self.name = name

    def tree_flatten(self):
        return ((self.perm, self.bsr, self.res),
                (self.res_fmt, self.shape, self.nnz, self.stats, self.name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        perm, bsr, res = children
        return cls(perm, bsr, res, *aux)

    @property
    def mem_footprint(self) -> int:
        tot = 0 if self.perm is None else self.perm.size * 4
        if self.bsr is not None:
            tot += self.bsr.blocks.size * self.bsr.blocks.dtype.itemsize \
                + self.bsr.block_rows.size * 8
        if self.res is not None:
            tot += getattr(self.res, "mem_footprint", 0) or 0
        return tot

    @classmethod
    def from_csr(cls, csr: CSRMatrix, *, n_hint: int = 512,
                 threshold: Optional[int] = None,
                 residual: str = "auto",
                 methods: Tuple[str, ...] = ("identity", "first_use",
                                             "centroid")) -> "DeviceRBH":
        thresh = auto_threshold(n_hint) if threshold is None else threshold
        rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.degrees)
        cols = csr.col_idx.astype(np.int64)

        # inspect: score each candidate ordering by ESTIMATED EXECUTOR
        # COST — dense passes over kept blocks + gather residual + (for
        # non-identity orders) the per-call X perm-gather.  Fraction alone
        # would miss that a reorder packing the same nnz into 6x fewer
        # blocks is 6x cheaper on the block part.
        from spgrid.ops.costmodel import C, residual_per_nnz
        per_block = max(BLOCK * n_hint * 4 / C.eff_bw,
                        2.0 * BLOCK * BLOCK * n_hint / C.matmul_f32)
        res_per_nnz = residual_per_nnz(n_hint, C)
        src_big = csr.k * n_hint * 4 > C.gather_cliff
        perm_cost = csr.k / (C.gather_slow if src_big else C.gather_fast)
        best = None
        for method in methods:
            if method == "identity":
                perm_np, cnew = None, cols
            else:
                perm_np = (first_use_col_order(csr) if method == "first_use"
                           else centroid_col_order(csr))
                inv = np.empty(csr.k, dtype=np.int64)
                inv[perm_np] = np.arange(csr.k)
                cnew = inv[cols]
            mask, nb = _hi_mask(rows, cnew, csr.k, thresh)
            lo = csr.nnz - int(mask.sum())
            cost = nb * per_block + lo * res_per_nnz \
                + (0.0 if method == "identity" else perm_cost)
            if best is None or cost < best[0]:
                best = (cost, method, perm_np, cnew, mask, nb)
        _, method, perm_np, cnew, mask, nb = best

        hi_nnz = int(mask.sum())
        if hi_nnz == 0 or nb == 0:
            method, perm_np, cnew = "identity", None, cols
            mask = np.zeros(csr.nnz, dtype=bool)
            hi_nnz, nb = 0, 0

        def _sub(sel) -> CSRMatrix:
            return coo_to_csr(COOMatrix(
                rows[sel].astype(np.int32), cnew[sel].astype(np.int32),
                csr.values[sel], csr.shape, csr.name), sum_duplicates=False)

        bsr = None
        if hi_nnz:
            bsr = DeviceBSR.from_csr(_sub(mask), bm=BLOCK, bk=BLOCK)
        res = None
        lo_nnz = csr.nnz - hi_nnz
        if lo_nnz:
            lo = _sub(~mask)
            if residual == "auto":
                # cost-model pick on the RESIDUAL's own features: sell
                # pays ~4m padded slots + three (m, n) permutation passes
                # regardless of nnz, so on a small residual merge or coo
                # can be cheaper
                from spgrid.features.structural import matrix_features
                from spgrid.ops.costmodel import estimate_spmm_time
                lf = matrix_features(lo)
                residual = min(
                    ("sell", "merge", "coo"),
                    key=lambda fmt: estimate_spmm_time(lf, fmt, n_hint))
            if residual == "sell":
                res = DeviceSELL.from_csr(lo)
            elif residual == "merge":
                from spgrid.ops.merge import DeviceMerge
                res = DeviceMerge.from_csr(lo)
            elif residual == "coo":
                from spgrid.ops.layouts import DeviceCOO
                res = DeviceCOO.from_csr(lo)
            else:
                raise ValueError(f"unknown residual fmt {residual!r}")
        stats = SplitStats(method=method, threshold=thresh, hi_nnz=hi_nnz,
                           lo_nnz=lo_nnz, hi_blocks=nb,
                           hi_fill=(hi_nnz / max(nb, 1)) / (BLOCK * BLOCK),
                           hi_frac=hi_nnz / max(csr.nnz, 1))
        perm = None if perm_np is None else jnp.asarray(
            perm_np.astype(np.int32))
        return cls(perm, bsr, res, residual, csr.shape, csr.nnz, stats,
                   csr.name)


def rbh_spmm(a: DeviceRBH, x: jax.Array) -> jax.Array:
    """Y = A @ X.  The column-perm gather on X is part of the call — the
    measured time is the honest full cost; amortized (pre-permuted X)
    numbers are reported separately by scripts/exp_reorder.py."""
    xp = x if a.perm is None else jnp.take(x, a.perm, axis=0)
    y = None
    if a.bsr is not None:
        y = bsr_spmm(a.bsr, xp)
    if a.res is not None:
        if a.res_fmt == "merge":
            from spgrid.ops.merge import merge_spmm
            fn = merge_spmm
        else:
            fn = xops.spmm_sell if a.res_fmt == "sell" else xops.spmm_coo
        yr = fn(a.res, xp)
        y = yr if y is None else (y + yr.astype(y.dtype))
    if y is None:
        y = jnp.zeros((a.shape[0], x.shape[1]), x.dtype)
    return y.astype(x.dtype)
