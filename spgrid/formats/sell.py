"""SELL-C-sigma: sliced ELL with sigma-window row sorting.

Reference integration: ``benchmark_code/CPU/ARM/spmv_code_sell-C-s`` (ESSEX/
GHOST ``SELL-32-1``).  SELL-C-sigma is *already* the device-friendly layout the
survey calls for (SURVEY §7 step 2): rows are sorted by degree inside windows
of ``sigma`` rows, grouped into slices of ``C`` rows (C = sublane count), and
each slice padded to its own width — wasting far less than plain ELL on
skewed matrices.

Device representation: slices are binned into power-of-two width *buckets*;
each bucket is a dense (num_slices, C, w) array pair, so a whole matrix is a
handful of static-shape tensors regardless of row-length skew.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from spgrid.formats.csr import CSRMatrix, IDX_DTYPE


@dataclasses.dataclass
class SELLBucket:
    slice_rows: np.ndarray   # (s,) int32 — first (permuted) row of each slice
    cols: np.ndarray         # (s, C, w) int32
    values: np.ndarray       # (s, C, w) dtype


@dataclasses.dataclass
class SELLMatrix:
    perm: np.ndarray          # (m,) int32: perm[i] = original row stored at slot i
    inv_perm: np.ndarray      # (m,) int32
    buckets: List[SELLBucket]
    C: int
    sigma: int
    shape: Tuple[int, int]
    nnz: int
    name: str = "sell"

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def mem_footprint(self) -> int:
        total = self.perm.nbytes
        for b in self.buckets:
            total += b.cols.nbytes + b.values.nbytes + b.slice_rows.nbytes
        return total

    @property
    def padding_ratio(self) -> float:
        padded = sum(b.cols.size for b in self.buckets)
        return padded / max(self.nnz, 1)


def csr_to_sell(csr: CSRMatrix, *, C: int = 8, sigma: int = 256,
                width_quantum: int = 4) -> SELLMatrix:
    """Build SELL-C-sigma from CSR.

    sigma-window sort: within each window of ``sigma`` rows, order rows by
    decreasing degree so slices group similar lengths (GHOST semantics).
    Slice widths are rounded up to ``width_quantum`` then binned by
    power-of-two for a small number of distinct device shapes.
    """
    m = csr.m
    d = csr.degrees
    perm = np.empty(m, dtype=np.int64)
    for w0 in range(0, m, sigma):
        w1 = min(w0 + sigma, m)
        order = np.argsort(-d[w0:w1], kind="stable")
        perm[w0:w1] = w0 + order
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(m)

    num_slices = -(-m // C)
    # Width of each slice = max degree among its rows, rounded up.
    slice_widths = np.zeros(num_slices, dtype=np.int64)
    for s in range(num_slices):
        rows = perm[s * C:(s + 1) * C]
        wmax = int(d[rows].max()) if len(rows) else 0
        slice_widths[s] = -(-max(wmax, 1) // width_quantum) * width_quantum

    # Bucket slices by next power of two of their width.
    def bucket_width(w):
        return 1 << int(np.ceil(np.log2(max(w, 1))))

    bucket_map: dict[int, list[int]] = {}
    for s in range(num_slices):
        bucket_map.setdefault(bucket_width(slice_widths[s]), []).append(s)

    buckets = []
    for w, slices in sorted(bucket_map.items()):
        s_count = len(slices)
        cols = np.zeros((s_count, C, w), dtype=IDX_DTYPE)
        vals = np.zeros((s_count, C, w), dtype=csr.values.dtype)
        slice_rows = np.zeros(s_count, dtype=IDX_DTYPE)
        for bi, s in enumerate(slices):
            slice_rows[bi] = s * C
            rows = perm[s * C:(s + 1) * C]
            for ci, r in enumerate(rows):
                lo, hi = csr.row_ptr[r], csr.row_ptr[r + 1]
                cols[bi, ci, : hi - lo] = csr.col_idx[lo:hi]
                vals[bi, ci, : hi - lo] = csr.values[lo:hi]
        buckets.append(SELLBucket(slice_rows, cols, vals))

    return SELLMatrix(
        perm=perm.astype(IDX_DTYPE),
        inv_perm=inv_perm.astype(IDX_DTYPE),
        buckets=buckets,
        C=C,
        sigma=sigma,
        shape=csr.shape,
        nnz=csr.nnz,
        name=csr.name,
    )


def sell_to_dense(sell: SELLMatrix) -> np.ndarray:
    """Reconstruct the dense matrix (test utility)."""
    m, k = sell.shape
    out_dtype = sell.buckets[0].values.dtype if sell.buckets else np.float32
    out = np.zeros((m, k), dtype=out_dtype)
    for b in sell.buckets:
        s_count, C, w = b.cols.shape
        for bi in range(s_count):
            for ci in range(C):
                slot = int(b.slice_rows[bi]) + ci
                if slot >= m:
                    continue
                r = int(sell.perm[slot])
                nz = b.values[bi, ci] != 0
                out[r, b.cols[bi, ci][nz]] += b.values[bi, ci][nz]
    return out
