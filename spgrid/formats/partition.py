"""Work partitioners: equal-iteration, nnz-balanced, mixed-cost, merge-path.

Reimplements ``lib/parallel_util.h`` for a device mesh.  The reference used
these to assign row ranges to OpenMP threads; here the same boundaries define
kernel blocks and shard boundaries.  The nnz-prefix-sum balancer
(``loop_partitioner_balance_prefix_sums``, parallel_util.h:141-165) is a
binary search on the rowptr prefix sums — exactly ``np.searchsorted``.
"""

from __future__ import annotations

import numpy as np


def balance_iterations(num_iters: int, num_parts: int) -> np.ndarray:
    """Equal-iteration split: boundaries array of shape (num_parts+1,).

    Remainder iterations are spread one-per-part from the front
    (parallel_util.h:47-126 semantics).
    """
    base, rem = divmod(num_iters, num_parts)
    sizes = np.full(num_parts, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def balance_prefix_sums(row_ptr: np.ndarray, num_parts: int) -> np.ndarray:
    """nnz-balanced row boundaries: part p covers rows [b[p], b[p+1]).

    Each part receives ~nnz/num_parts nonzeros; boundaries land on whole rows
    (parallel_util.h:141-165).  Monotone by construction.
    """
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    nnz = row_ptr[-1]
    m = len(row_ptr) - 1
    targets = (np.arange(1, num_parts, dtype=np.float64) * nnz / num_parts)
    cuts = np.searchsorted(row_ptr, targets, side="left")
    bounds = np.concatenate([[0], cuts, [m]])
    return np.maximum.accumulate(bounds)


def balance_mixed(row_ptr: np.ndarray, num_parts: int,
                  rows_weight: float = 0.5) -> np.ndarray:
    """Mixed cost model: cost_i = w*1 + (1-w)*nnz_i per row
    (``loop_partitioner_balance``, parallel_util.h:189-214)."""
    row_ptr = np.asarray(row_ptr, dtype=np.float64)
    m = len(row_ptr) - 1
    nnz = row_ptr[-1]
    if nnz == 0:
        return balance_iterations(m, num_parts)
    # Combined prefix: rows_weight normalized per-row + nnz share.
    rows_prefix = np.arange(m + 1, dtype=np.float64) / max(m, 1)
    nnz_prefix = row_ptr / nnz
    combined = rows_weight * rows_prefix + (1.0 - rows_weight) * nnz_prefix
    targets = np.arange(1, num_parts, dtype=np.float64) / num_parts
    cuts = np.searchsorted(combined, targets, side="left")
    bounds = np.concatenate([[0], cuts, [m]])
    return np.maximum.accumulate(bounds).astype(np.int64)


def merge_path_blocks(row_ptr: np.ndarray, block_nnz: int):
    """Perfect-nnz-balance decomposition (SURVEY A.3).

    Splits [0, nnz) into equal blocks of ``block_nnz``; for each block
    returns the row containing its first nonzero.  Rows straddling block
    boundaries are *shared*: block partials for the boundary row are summed
    in a segmented epilogue — the merge-path / segmented-reduction pattern of
    ``spmv_kernel_csr.cpp:68-110,624-680``.

    Returns (block_first_row, num_blocks) with block_first_row int32 of shape
    (num_blocks,).
    """
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    nnz = int(row_ptr[-1])
    num_blocks = max(1, -(-nnz // block_nnz))
    starts = np.arange(num_blocks, dtype=np.int64) * block_nnz
    # row containing nnz index s: searchsorted right - 1
    first_row = np.searchsorted(row_ptr, starts, side="right") - 1
    return first_row.astype(np.int32), num_blocks
