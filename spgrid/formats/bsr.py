"""BSR / block-CSR: dense blocks — the matmul-unit sparse layout.

Reference exposes MKL BSR with block sizes 2..64
(``AMD/spmv_code_bench/Makefile_in`` mkl_bsr targets).  Dense blocks are
how sparse flops reach the matrix units: each stored (bm x bk) block
multiplies a (bk x n) dense slab at matmul throughput.
The block grid is stored CSR-style over block rows.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spgrid.formats.csr import CSRMatrix, IDX_DTYPE, coo_to_csr, COOMatrix


@dataclasses.dataclass
class BSRMatrix:
    block_row_ptr: np.ndarray   # (mb+1,) int32
    block_col_idx: np.ndarray   # (nb,)   int32 — block-column of each block
    blocks: np.ndarray          # (nb, bm, bk) dtype — dense block values
    shape: Tuple[int, int]      # logical (m, k), pre-padding
    nnz: int                    # true scalar nnz (flop accounting)
    name: str = "bsr"

    @property
    def bm(self) -> int:
        return self.blocks.shape[1]

    @property
    def bk(self) -> int:
        return self.blocks.shape[2]

    @property
    def mb(self) -> int:
        return len(self.block_row_ptr) - 1

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def mem_footprint(self) -> int:
        return (self.blocks.nbytes + self.block_col_idx.nbytes
                + self.block_row_ptr.nbytes)

    @property
    def block_density(self) -> float:
        """Fraction of stored block slots that hold true nonzeros."""
        return self.nnz / max(self.blocks.size, 1)


def csr_to_bsr(csr: CSRMatrix, bm: int = 8, bk: int = 128,
               use_native: bool = True) -> BSRMatrix:
    """Build BSR by densifying every (bm x bk) tile that contains a nonzero.

    Uses the parallel C++ builder (spgrid.io.native sg_csr_to_bsr_f32) when
    available for f32 matrices; the numpy path below is the behavioral
    reference and the fallback."""
    if use_native and csr.values.dtype == np.float32:
        try:
            from spgrid.io.native import csr_to_bsr_native
            nat = csr_to_bsr_native(csr, bm, bk)
        except Exception:
            nat = None
        if nat is not None:
            brp, bci, blocks = nat
            return BSRMatrix(brp, bci, blocks, csr.shape, csr.nnz, csr.name)
    m, k = csr.shape
    mb = -(-m // bm)
    kb = -(-k // bk)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    brow = rows // bm
    bcol = cols // bk
    key = brow * kb + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, inv_start = np.unique(key_s, return_index=True)
    nb = len(uniq)

    blocks = np.zeros((nb, bm, bk), dtype=csr.values.dtype)
    # block index of each nnz (in sorted order)
    block_of = np.searchsorted(uniq, key_s)
    r_in = (rows[order] % bm)
    c_in = (cols[order] % bk)
    blocks[block_of, r_in, c_in] = csr.values[order]

    ub_row = (uniq // kb).astype(np.int64)
    ub_col = (uniq % kb).astype(IDX_DTYPE)
    block_row_ptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(block_row_ptr, ub_row + 1, 1)
    block_row_ptr = np.cumsum(block_row_ptr)

    return BSRMatrix(
        block_row_ptr=block_row_ptr.astype(IDX_DTYPE),
        block_col_idx=ub_col,
        blocks=blocks,
        shape=csr.shape,
        nnz=csr.nnz,
        name=csr.name,
    )


def bsr_to_csr(bsr: BSRMatrix) -> CSRMatrix:
    m, k = bsr.shape
    nb, bm, bk = bsr.blocks.shape
    brows = np.repeat(
        np.arange(bsr.mb, dtype=np.int64), np.diff(bsr.block_row_ptr)
    )
    b, r, c = np.nonzero(bsr.blocks)
    rows = brows[b] * bm + r
    cols = bsr.block_col_idx.astype(np.int64)[b] * bk + c
    keep = (rows < m) & (cols < k)
    return coo_to_csr(
        COOMatrix(rows[keep], cols[keep], bsr.blocks[b, r, c][keep],
                  bsr.shape, bsr.name),
        sum_duplicates=False,
    )
