"""Device-resident accuracy oracle: double-float gold + on-device metrics.

Re-designs the reference's ``CheckAccuracy`` (spmv_code_bench/
spmv_bench.cpp:121-206) and error vector (lib/array_metrics.c; SURVEY A.4)
for large results.  The host float64+Kahan oracle (core/metrics.py)
remains the *definition* of correctness; this module computes an
equivalent-precision gold ON DEVICE so that gating a benchmark row costs a
~10-scalar fetch instead of an (m, n) result download plus an m x n host
f64 pass — at m=2.2M, n=512 that result is 4.5 GB.

Precision: the gold SpMM accumulates in double-float (a.k.a. float32
"double-double"): products via Dekker/Veltkamp error-free two_prod, sums
via Knuth two_sum with compensated carry.  Effective mantissa ~2^-48,
i.e. the same >2x margin over the f32/bf16 device kernels that the
reference's __float128 gold had over its double kernels.  Agreement with
the host f64 oracle is pinned by tests (< 1e-12 relative).

Skew tails: rows whose degree exceeds the ELL slot budget are excluded
from the device pass and checked on HOST in exact float64 (their test
rows are a small (T, n) fetch); the metric partial sums of both passes
are merged exactly.  No matrix falls off the oracle.

The error-free transforms rely on IEEE f32 semantics of +,-,*; XLA does
not apply unsafe floating-point reassociation by default, on GPU or CPU
(checked on the H100 by chip_smoke.py phase 4).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.core.metrics import ErrorMetrics, error_metrics

# Slot budget for the gold ELL: cap device memory at ~1.5GB and the
# per-step gather loop at 8192 slots; rows above it go to the host tail.
_MAX_SLOT_BYTES = 1536 << 20
_MAX_SLOTS = 8192


# ---------------------------------------------------------------------------
# double-float primitives (f32 error-free transforms)

def _two_sum(a, b):
    """Knuth's branch-free TwoSum: s + e == a + b exactly (IEEE f32)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _mask_split(a):
    """Split f32 into 12-bit-significand halves via integer masking.

    The classic Veltkamp split (c = a*(2^12+1); hi = c - (c - a)) is NOT
    safe under XLA: backends may contract multiply+subtract chains into
    FMAs (measured on XLA:CPU regardless of fast-math/excess-precision
    flags and optimization barriers), which un-rounds the very products
    the split depends on.  Masking the low 12 stored mantissa bits is
    pure integer work the optimizer cannot alter; hi keeps an 11+1-bit
    significand and lo = a - hi is exact (aligned low bits), so every
    cross product of two halves fits f32's 24-bit significand exactly —
    making the two_prod below immune to FMA contraction (contracting an
    exact product changes nothing).
    """
    ui = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(ui & jnp.uint32(0xFFFFF000),
                                      jnp.float32)
    return hi, a - hi


def _two_prod(a, b):
    """Contraction-proof TwoProduct: s + e == a * b exactly.

    All four half-products are exactly representable (12x12-bit
    significands), so the only rounding is in the two_sum chain, which
    contains no multiplies for a backend to contract.
    """
    ah, al = _mask_split(a)
    bh, bl = _mask_split(b)
    s, e1 = _two_sum(ah * bh, ah * bl)
    s, e2 = _two_sum(s, al * bh)
    s, e3 = _two_sum(s, al * bl)
    return s, (e1 + e2) + e3


# ---------------------------------------------------------------------------
# gold SpMM on device

@jax.jit
def _dd_gold_ell(cols, vals, x):
    """Double-float gold SpMM from an ELL layout.

    cols (m2, S) int32 (padding: col 0), vals (m2, S) f32 (padding: 0),
    x (k, n) f32.  Returns (hi, lo) with hi + lo == sum_s vals[:,s] *
    x[cols[:,s]] to ~2^-48 relative.
    """
    m2, S = cols.shape
    n = x.shape[1]

    def body(s, carry):
        # three-term cascade: hi + lo + cc; the error of every two_sum
        # is itself two_sum-accumulated into lo, and lo's own rounding
        # drops into the plain third accumulator — oracle noise floor
        # ~1e-14 relative instead of the ~1e-11 a plain lo gives over
        # thousands of error terms
        hi, lo, cc = carry
        xv = jnp.take(x, cols[:, s], axis=0)          # (m2, n) row gather
        p, pe = _two_prod(vals[:, s][:, None], xv)
        hi, e = _two_sum(hi, p)
        lo, c1 = _two_sum(lo, e)
        lo, c2 = _two_sum(lo, pe)
        return hi, lo, cc + (c1 + c2)

    z = jnp.zeros((m2, n), jnp.float32)
    hi, lo, cc = jax.lax.fori_loop(0, S, body, (z, z, z))
    return hi, lo + cc


@partial(jax.jit, static_argnames=("eps",))
def _metric_partials(hi, lo, test, include, eps):
    """Per-entry error terms + per-COLUMN reductions, all on device.

    a (gold) = hi + lo in double-float; d = test - a computed as
    (test - hi) - lo, exact to ~eps_f32^2 since test and hi agree to
    f32 rounding.  Rows with include==False contribute nothing.

    Sums reduce over the (large) row axis on device and leave the (n,)
    column axis for the host to finish in float64 — an (n,) fetch is
    still tiny and it keeps the f32 tree-reduction depth at log2(m),
    plus int32 per-column counts can never overflow (m < 2^31).
    """
    inc = include[:, None]
    d = jnp.where(inc, (test - hi) - lo, 0.0)
    a = jnp.where(inc, hi + lo, 0.0)
    f = jnp.where(inc, test, 0.0)
    ad = jnp.abs(d)
    aa = jnp.abs(a)
    af = jnp.abs(f)

    nz = inc & (aa > 0)
    denom = aa + af
    dz = inc & (denom > 0)
    tiny = jnp.float32(eps)
    lnq_t = jnp.where(
        inc,
        jnp.log10(jnp.maximum(af, tiny)) - jnp.log10(jnp.maximum(aa, tiny)),
        0.0)
    sig = aa > eps
    rel = jnp.where(sig, ad / jnp.where(sig, aa, 1.0), ad)

    col = dict(
        sum_ad=jnp.sum(ad, axis=0),
        sum_d2=jnp.sum(d * d, axis=0),
        sum_ape=jnp.sum(jnp.where(nz, ad / jnp.where(nz, aa, 1.0), 0.0),
                        axis=0),
        cnt_nz=jnp.sum(nz, axis=0, dtype=jnp.int32),
        sum_sape=jnp.sum(jnp.where(dz, 2.0 * ad / jnp.where(dz, denom, 1.0),
                                   0.0), axis=0),
        cnt_dz=jnp.sum(dz, axis=0, dtype=jnp.int32),
        sum_lnq=jnp.sum(lnq_t, axis=0),
    )
    col["max_ad"] = jnp.max(ad)
    col["max_rel"] = jnp.max(jnp.where(inc, rel, 0.0))
    return col


@dataclasses.dataclass
class _Partials:
    """Mergeable metric partial sums (host floats)."""

    sum_ad: float = 0.0
    max_ad: float = 0.0
    sum_d2: float = 0.0
    sum_ape: float = 0.0
    cnt_nz: int = 0
    sum_sape: float = 0.0
    cnt_dz: int = 0
    sum_lnq: float = 0.0
    max_rel: float = 0.0
    cnt: int = 0

    def merge(self, o: "_Partials") -> "_Partials":
        return _Partials(
            sum_ad=self.sum_ad + o.sum_ad,
            max_ad=max(self.max_ad, o.max_ad),
            sum_d2=self.sum_d2 + o.sum_d2,
            sum_ape=self.sum_ape + o.sum_ape,
            cnt_nz=self.cnt_nz + o.cnt_nz,
            sum_sape=self.sum_sape + o.sum_sape,
            cnt_dz=self.cnt_dz + o.cnt_dz,
            sum_lnq=self.sum_lnq + o.sum_lnq,
            max_rel=max(self.max_rel, o.max_rel),
            cnt=self.cnt + o.cnt,
        )


def _host_partials(gold: np.ndarray, test: np.ndarray,
                   eps: float) -> _Partials:
    """Exact-f64 partials for host-handled rows (same A.4 semantics)."""
    a = np.asarray(gold, np.float64).ravel()
    f = np.asarray(test, np.float64).ravel()
    d = np.abs(a - f)
    aa, af = np.abs(a), np.abs(f)
    nz = aa > 0
    denom = aa + af
    dz = denom > 0
    tiny = max(eps, np.finfo(np.float64).tiny)
    lnq = (np.log10(np.maximum(af, tiny)) - np.log10(np.maximum(aa, tiny)))
    sig = aa > eps
    rel = np.where(sig, d / np.where(sig, aa, 1.0), d)
    return _Partials(
        sum_ad=float(d.sum()), max_ad=float(d.max(initial=0.0)),
        sum_d2=float((d * d).sum()),
        sum_ape=float((d[nz] / aa[nz]).sum()), cnt_nz=int(nz.sum()),
        sum_sape=float((2.0 * d[dz] / denom[dz]).sum()), cnt_dz=int(dz.sum()),
        sum_lnq=float(lnq.sum()),
        max_rel=float(rel.max(initial=0.0)), cnt=int(a.size),
    )


def _finish(p: _Partials, eps: float) -> ErrorMetrics:
    n = max(p.cnt, 1)
    lnq = p.sum_lnq / n if p.cnt else 0.0
    mlare = (float(np.log10(abs(10.0 ** lnq - 1.0))) if lnq != 0.0
             else -math.inf)
    return ErrorMetrics(
        mae=p.sum_ad / n,
        max_ae=p.max_ad,
        mse=p.sum_d2 / n,
        mape=p.sum_ape / p.cnt_nz if p.cnt_nz else 0.0,
        smape=p.sum_sape / p.cnt_dz if p.cnt_dz else 0.0,
        lnQ_error=lnq,
        mlare=mlare,
        gmare=float(10.0 ** mlare),
        max_rel_diff=p.max_rel,
        passed=bool(p.max_rel <= eps),
    )


# ---------------------------------------------------------------------------
# public driver

class DeviceOracle:
    """One matrix's device-resident oracle, reusable across kernel rows.

    Build once per (matrix, accuracy class): uploads a gold ELL (cols +
    values, ~the matrix's own footprint) and keeps the (hi, lo) gold
    activation on device after the first ``check``.  Heavy rows (degree
    over the slot budget) are checked on host in float64.
    """

    def __init__(self, row_ptr: np.ndarray, col_idx: np.ndarray,
                 values: np.ndarray, m: int, k: int,
                 max_slots: int = _MAX_SLOTS):
        deg = np.diff(row_ptr).astype(np.int64)
        m2 = max(-(-m // 8) * 8, 8)
        s_budget = int(min(max_slots,
                           max(_MAX_SLOT_BYTES // (8 * m2), 1)))
        maxdeg = int(deg.max(initial=0))
        S = min(maxdeg, s_budget)
        # pow2 slot bucket: fewer distinct compiled shapes across a sweep
        S = 1 << max(int(math.ceil(math.log2(max(S, 1)))), 0)
        heavy = np.flatnonzero(deg > S)
        self.heavy_rows = heavy
        self.m, self.k, self.m2, self.S = m, k, m2, S

        cols = np.zeros((m2, S), np.int32)
        vals = np.zeros((m2, S), np.float32)
        light = deg <= S
        nnz_idx = np.arange(len(col_idx), dtype=np.int64)
        row_of = np.repeat(np.arange(m, dtype=np.int64), deg)
        within = nnz_idx - np.repeat(row_ptr[:-1].astype(np.int64), deg)
        take = light[row_of]
        cols[row_of[take], within[take]] = col_idx[take].astype(np.int32)
        vals[row_of[take], within[take]] = values[take].astype(np.float32)
        self._cols = jnp.asarray(cols)
        self._vals = jnp.asarray(vals)
        # heavy rows' CSR slices, for the host-f64 pass
        self._heavy_csr = None
        if len(heavy):
            hr_ptr = np.zeros(len(heavy) + 1, np.int64)
            hr_cols, hr_vals = [], []
            for i, r in enumerate(heavy):
                s, e = row_ptr[r], row_ptr[r + 1]
                hr_cols.append(col_idx[s:e])
                hr_vals.append(values[s:e])
                hr_ptr[i + 1] = hr_ptr[i] + (e - s)
            self._heavy_csr = (hr_ptr, np.concatenate(hr_cols),
                               np.concatenate(hr_vals).astype(np.float64))
        inc = np.zeros(m2, bool)
        inc[:m] = light
        self._include = jnp.asarray(inc)
        self._n_light = int(light.sum())
        self._gold = None          # (hi, lo) device arrays, per x identity
        self._gold_key = None

    @classmethod
    def from_csr(cls, csr, max_slots: int = _MAX_SLOTS) -> "DeviceOracle":
        return cls(np.asarray(csr.row_ptr), np.asarray(csr.col_idx),
                   np.asarray(csr.values), csr.m, csr.k,
                   max_slots=max_slots)

    def _ensure_gold(self, xd: jax.Array):
        key = id(xd)
        if self._gold is None or self._gold_key != key:
            xf = xd.astype(jnp.float32)
            self._gold = _dd_gold_ell(self._cols, self._vals, xf)
            self._gold_key = key

    def check(self, test: jax.Array, xd: jax.Array, eps: float,
              x_host: Optional[np.ndarray] = None) -> ErrorMetrics:
        """Gate ``test`` (device (m, n) array) against the device gold.

        ``x_host`` is required when the matrix has heavy rows (host f64
        pass); pass the same operand values the kernel consumed.
        """
        self._ensure_gold(xd)
        hi, lo = self._gold
        t32 = test.astype(jnp.float32)
        if t32.shape[0] != self.m2:
            t32 = jnp.pad(t32, ((0, self.m2 - t32.shape[0]), (0, 0)))
        dev = jax.device_get(
            _metric_partials(hi, lo, t32, self._include, float(eps)))
        n = int(test.shape[1])
        p = _Partials(
            sum_ad=float(np.sum(dev["sum_ad"], dtype=np.float64)),
            max_ad=float(dev["max_ad"]),
            sum_d2=float(np.sum(dev["sum_d2"], dtype=np.float64)),
            sum_ape=float(np.sum(dev["sum_ape"], dtype=np.float64)),
            cnt_nz=int(np.sum(dev["cnt_nz"], dtype=np.int64)),
            sum_sape=float(np.sum(dev["sum_sape"], dtype=np.float64)),
            cnt_dz=int(np.sum(dev["cnt_dz"], dtype=np.int64)),
            sum_lnq=float(np.sum(dev["sum_lnq"], dtype=np.float64)),
            max_rel=float(dev["max_rel"]),
            cnt=self._n_light * n,
        )
        if len(self.heavy_rows):
            if x_host is None:
                raise ValueError("matrix has heavy rows: x_host required")
            hr_ptr, hr_cols, hr_vals = self._heavy_csr
            x64 = np.asarray(x_host, np.float64)
            prods = hr_vals[:, None] * x64[hr_cols]
            gold_h = np.add.reduceat(prods, hr_ptr[:-1], axis=0) \
                if len(hr_vals) else np.zeros((0, x64.shape[1]))
            empty = hr_ptr[:-1] == hr_ptr[1:]
            gold_h[empty] = 0.0
            test_h = np.asarray(
                jnp.take(test, jnp.asarray(self.heavy_rows), axis=0),
                np.float64)
            p = p.merge(_host_partials(gold_h, test_h, eps))
        return _finish(p, eps)


def device_x(k: int, n: int, dtype: str, seed: int) -> jax.Array:
    """Dense operand generated ON device: uniform [0.5, 1.5), matching
    make_x's distribution (positive, no cancellation) — not its bits.

    Threefry is counter-based and bit-deterministic across JAX backends,
    so ``host_x_of_device`` reproduces the same values on CPU for the
    oracle's host passes; a sample equality check guards the assumption
    at run time (see harness).
    """
    key = jax.random.PRNGKey(seed ^ 0x5EED)
    x = jax.random.uniform(key, (k, n), jnp.float32, 0.5, 1.5)
    return x.astype(dtype)


def host_x_of_device(k: int, n: int, dtype: str, seed: int) -> np.ndarray:
    """Recompute device_x's exact values on the CPU backend."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return np.asarray(jax.jit(lambda: device_x(k, n, dtype, seed))())
