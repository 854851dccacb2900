"""Numerical-accuracy oracle and the 8-metric error vector.

Reimplements the reference's ``CheckAccuracy`` contract
(``spmv_code_bench/spmv_bench.cpp:121-206``) and error-metric definitions
(``lib/array_metrics.c``; exact formulas cited per metric below).  The
reference computes the gold result in ``__float128`` with Kahan compensated
summation; here the device computes in bf16/f32, so a float64
Kahan host oracle gives the same >2x-precision margin the reference had over
its double kernels.
"""

from __future__ import annotations

import dataclasses
import numpy as np


def kahan_sum(values: np.ndarray, axis: int = -1) -> np.ndarray:
    """Kahan compensated summation along ``axis`` in float64.

    Mirrors the compensated loop of the reference gold SpMM
    (spmv_bench.cpp:143-160: ``y = t; c = (t - y_prev) - val``).
    """
    values = np.asarray(values, dtype=np.float64)
    values = np.moveaxis(values, axis, 0)
    s = np.zeros(values.shape[1:], dtype=np.float64)
    c = np.zeros_like(s)
    for i in range(values.shape[0]):
        y = values[i] - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


@dataclasses.dataclass
class ErrorMetrics:
    """The 8-metric error vector of ``lib/array_metrics.c`` (SURVEY A.4)."""

    mae: float        # mean |a - f|
    max_ae: float     # max  |a - f|
    mse: float        # mean (a - f)^2
    mape: float       # mean |a - f| / |a|          (a != 0)
    smape: float      # mean 2|a - f| / (|a| + |f|) (denominator != 0)
    lnQ_error: float  # mean log10(max(|f|,eps)) - log10(max(|a|,eps))
                      #   (array_metrics.c:1934,1955-1958)
    mlare: float      # log10 |10^lnQ - 1|          (array_metrics.c:1976-1984)
    gmare: float      # 10^mlare                    (array_metrics.c:2134-2139)

    # Gate fields (spmv_bench.cpp:163-202)
    max_rel_diff: float
    passed: bool

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def error_metrics(
    gold: np.ndarray,
    test: np.ndarray,
    epsilon: float,
) -> ErrorMetrics:
    """Compute the full error vector of ``test`` against ``gold``.

    Pass/fail gate: max relative difference, computed only where
    ``|gold| > epsilon`` (absolute difference gates the rest), must stay
    below ``epsilon`` — spmv_bench.cpp:163-188.
    """
    a = np.asarray(gold, dtype=np.float64).ravel()
    f = np.asarray(test, dtype=np.float64).ravel()
    if a.shape != f.shape:
        raise ValueError(f"shape mismatch: gold {a.shape} vs test {f.shape}")

    diff = np.abs(a - f)
    mae = float(diff.mean()) if a.size else 0.0
    max_ae = float(diff.max()) if a.size else 0.0
    mse = float(np.mean((a - f) ** 2)) if a.size else 0.0

    nz = np.abs(a) > 0
    mape = float(np.mean(diff[nz] / np.abs(a[nz]))) if nz.any() else 0.0

    denom = np.abs(a) + np.abs(f)
    dz = denom > 0
    smape = float(np.mean(2.0 * diff[dz] / denom[dz])) if dz.any() else 0.0

    tiny = max(epsilon, np.finfo(np.float64).tiny)
    lnq = float(
        np.mean(
            np.log10(np.maximum(np.abs(f), tiny))
            - np.log10(np.maximum(np.abs(a), tiny))
        )
    ) if a.size else 0.0
    mlare = float(np.log10(np.abs(10.0 ** lnq - 1.0))) if lnq != 0.0 else -np.inf
    gmare = float(10.0 ** mlare)

    # Gate: relative where gold is significant, absolute elsewhere.
    sig = np.abs(a) > epsilon
    rel = np.zeros_like(diff)
    rel[sig] = diff[sig] / np.abs(a[sig])
    rel[~sig] = diff[~sig]
    max_rel = float(rel.max()) if rel.size else 0.0

    return ErrorMetrics(
        mae=mae,
        max_ae=max_ae,
        mse=mse,
        mape=mape,
        smape=smape,
        lnQ_error=lnq,
        mlare=mlare,
        gmare=gmare,
        max_rel_diff=max_rel,
        passed=bool(max_rel <= epsilon),
    )


def accuracy_gate(gold: np.ndarray, test: np.ndarray, epsilon: float) -> ErrorMetrics:
    """Run the oracle check; print the reference-style failure line."""
    m = error_metrics(gold, test, epsilon)
    if not m.passed:
        # Reference prints "Test failed! (maxdiff)" (spmv_bench.cpp:187-202).
        print(f"Test failed! max_rel_diff={m.max_rel_diff:.3e} > eps={epsilon:.1e}")
    return m


def gold_spmm(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    x: np.ndarray,
) -> np.ndarray:
    """High-precision reference SpMM: CSR(m,k) @ x(k,n) in float64 + Kahan.

    Mirrors CheckAccuracy's quad-precision gold (spmv_bench.cpp:122-160),
    with float64+Kahan standing in for __float128 (the device computes at
    most f32, so the oracle retains a large precision margin).
    """
    m = len(row_ptr) - 1
    x64 = np.asarray(x, dtype=np.float64)
    n = x64.shape[1] if x64.ndim == 2 else 1
    x2 = x64.reshape(x64.shape[0], n)
    v = np.asarray(values, dtype=np.float64)
    out = np.zeros((m, n), dtype=np.float64)
    for i in range(m):
        s, e = row_ptr[i], row_ptr[i + 1]
        if e > s:
            prods = v[s:e, None] * x2[col_idx[s:e]]
            out[i] = kahan_sum(prods, axis=0)
    return out if x64.ndim == 2 else out[:, 0]


def gold_spmm_fast(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    x: np.ndarray,
) -> np.ndarray:
    """Vectorized float64 oracle (np.add.reduceat over row segments).

    Used by the benchmark harness on large matrices where the per-row Kahan
    loop is too slow; float64 straight summation still carries ~2^29 more
    mantissa margin than the f32/bf16 device kernels it gates."""
    m = len(row_ptr) - 1
    x64 = np.asarray(x, dtype=np.float64)
    squeeze = x64.ndim == 1
    x2 = x64.reshape(x64.shape[0], -1)
    v = np.asarray(values, dtype=np.float64)
    prods = v[:, None] * x2[col_idx]                     # (nnz, n)
    starts = np.asarray(row_ptr[:-1], dtype=np.int64)
    nnz = len(v)
    out = np.zeros((m, x2.shape[1]), dtype=np.float64)
    nonempty = starts < row_ptr[1:]
    if nnz and nonempty.any():
        # reduceat needs strictly valid segment starts; empty rows repeat the
        # next start and must be zeroed after.
        red = np.add.reduceat(prods, starts[nonempty], axis=0)
        out[nonempty] = red
    return out[:, 0] if squeeze else out
