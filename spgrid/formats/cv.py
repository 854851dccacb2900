"""Compressed-value (CV) sparse matrices.

Reference counterpart: the bit/byte-stream substrate for compressed-value
kernels (``lib/bitstream.c:1-262``, ``lib/bit_ops.h`` — FPC/ZFP-style value
compression that trades decode FLOPs for memory traffic on bandwidth-bound
SpMV).  The device equivalent is datatype narrowing the hardware decodes
for free: values stored as bf16, or as int8 with a per-row symmetric
absmax scale (dequantized inside the kernel).  Memory footprint drops 2x /
~4x, which is exactly the lever on a bandwidth-bound kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

try:
    import ml_dtypes
    _BF16 = ml_dtypes.bfloat16
except ImportError:  # pragma: no cover
    _BF16 = None

from spgrid.formats.csr import CSRMatrix, IDX_DTYPE

MODES = ("bf16", "int8")


@dataclasses.dataclass
class CVMatrix:
    """CSR with compressed values.

    ``qvalues`` holds bf16 values (mode='bf16') or int8 quantized values
    (mode='int8'); ``scales`` holds one f32 per row (absmax/127), unused for
    bf16.  ``mem_footprint`` counts the compressed value bytes + indices +
    rowptr + scales, the honest analogue of the reference's per-format
    footprint accounting (spmv_kernel.h:24).
    """

    row_ptr: np.ndarray    # (m+1,) int32
    col_idx: np.ndarray    # (nnz,) int32
    qvalues: np.ndarray    # (nnz,) bf16 | int8
    scales: np.ndarray     # (m,) float32 (int8 mode; empty for bf16)
    shape: Tuple[int, int]
    mode: str
    name: str = "cv"

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    @property
    def mem_footprint(self) -> int:
        ib = self.col_idx.dtype.itemsize
        vb = self.qvalues.dtype.itemsize
        return (self.nnz * (vb + ib) + (self.m + 1) * ib
                + self.scales.nbytes)


def csr_to_cv(csr: CSRMatrix, mode: str = "int8") -> CVMatrix:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    vals = csr.values.astype(np.float32)
    if mode == "bf16":
        if _BF16 is None:
            raise RuntimeError("ml_dtypes unavailable for bf16 host storage")
        q = vals.astype(_BF16)
        scales = np.zeros(0, dtype=np.float32)
    else:
        absmax = np.zeros(csr.m, dtype=np.float32)
        rows = np.repeat(np.arange(csr.m), csr.degrees)
        np.maximum.at(absmax, rows, np.abs(vals))
        scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(vals / scales[rows]), -127, 127).astype(np.int8)
    return CVMatrix(csr.row_ptr.copy(), csr.col_idx.copy(), q, scales,
                    csr.shape, mode, csr.name)


def cv_to_csr(cv: CVMatrix) -> CSRMatrix:
    """Dequantize back to f32 CSR (lossy round-trip)."""
    if cv.mode == "bf16":
        vals = cv.qvalues.astype(np.float32)
    else:
        rows = np.repeat(np.arange(cv.m), cv.degrees)
        vals = cv.qvalues.astype(np.float32) * cv.scales[rows]
    return CSRMatrix(cv.row_ptr.copy(), cv.col_idx.copy(), vals, cv.shape,
                     cv.name)


def quantization_error(csr: CSRMatrix, mode: str = "int8") -> float:
    """Max relative value error introduced by compression (for gating
    whether CV is admissible for a run's epsilon)."""
    deq = cv_to_csr(csr_to_cv(csr, mode)).values
    ref = csr.values.astype(np.float32)
    denom = np.maximum(np.abs(ref), 1e-30)
    return float(np.max(np.abs(deq - ref) / denom)) if len(ref) else 0.0


def select_cv_mode(values, tolerance: float, csr: CSRMatrix | None = None):
    """Pick the cheapest value-compression mode within `tolerance`.

    The reference extracts value features precisely to decide when value
    compression is safe (csr_util_gen.c:1458-2004 + lib/bitstream.c); this
    is that decision as a function.  The value features (unique count,
    kmeans residual) only *nominate* int8 — they are proxies, and neither
    bounds the error of a 255-level uniform grid (256 arbitrary uniques or
    a wide-dynamic-range row can quantize with ~100% relative error).  The
    nomination is verified against the ACTUAL quantization error: the
    row-scaled `quantization_error` when the CSR is available, else a
    conservative single-scale check on the value sample.  bf16 when ~3
    significant digits fit, else None (stay f32).
    """
    from spgrid.features.values import value_features
    import numpy as np
    v = np.asarray(values)
    if v.size == 0:
        return None
    vf = value_features(v)
    nominate_int8 = (vf.num_unique <= 256
                     or (tolerance >= 1e-2
                         and vf.kmeans_rel_error_8 <= tolerance))
    if nominate_int8:
        if csr is not None:
            err = quantization_error(csr, "int8")
        else:
            absmax = float(np.max(np.abs(v)))
            scale = absmax / 127.0 if absmax > 0 else 1.0
            deq = np.clip(np.rint(v / scale), -127, 127) * scale
            err = float(np.max(np.abs(deq - v)
                               / np.maximum(np.abs(v), 1e-30)))
        if err <= tolerance:
            return "int8"
    if tolerance >= 4e-3:          # bf16: 8-bit mantissa ~ 0.4% worst-case
        return "bf16"
    return None
