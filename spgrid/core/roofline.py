"""Roofline model: per-chip speed-of-light given flop and byte counts.

The reference reports GFLOPS against per-device plot ceilings
(``results_visualization/master_plotter_synthetic.ipynb`` y_limit_dictionary)
and footprint-derived memory traffic (``spmv_kernel.h:24``).  Here the
roofline is first-class: every benchmark row carries achieved GFLOPS, the
memory-bound speed-of-light for its traffic, and the fraction attained
(BASELINE.json target: >=70% of memory-bandwidth roofline per chip).

FLOP models (BASELINE.md "Measurement protocol"):
  sparse op   = 2 * nnz * n   (n = dense-operand width; spmv_bench.cpp:404-408)
  GEMM bound  = 2 * m * k * n (spmv_bench.cpp:400-403)
"""

from __future__ import annotations

import dataclasses
import math

import jax


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbytes_per_s: float       # device-memory bandwidth
    peak_bf16_tflops: float       # tensor cores, bf16 inputs / f32 accum
    peak_f32_tflops: float        # true f32 (the f32 rows run at HIGHEST)
    hbm_gbytes: float
    source: str = ""


# Published peaks, keyed by jax's device_kind.  A kind that is not here is
# an error, not a default: a roofline share against a guessed peak would
# be a made-up number.
H100_SXM = ChipSpec(
    name="NVIDIA H100 80GB HBM3", hbm_gbytes_per_s=3350.0,
    peak_bf16_tflops=989.0, peak_f32_tflops=67.0, hbm_gbytes=80.0,
    source="NVIDIA H100 SXM data sheet (dense rates, 700 W); TF32 is "
           "495 TFLOP/s but f32 rows run at HIGHEST, outside TF32",
)
# The CPU backend has no published peak: its rows carry NaN roofline
# columns.
CPU_HOST = ChipSpec(
    name="cpu", hbm_gbytes_per_s=math.nan, peak_bf16_tflops=math.nan,
    peak_f32_tflops=math.nan, hbm_gbytes=math.nan,
)

_CHIPS = {c.name: c for c in (H100_SXM,)}


def chip_for_kind(platform: str, kind: str) -> ChipSpec:
    if platform == "cpu":
        return CPU_HOST
    spec = _CHIPS.get(kind)
    if spec is None:
        raise ValueError(
            f"no published peaks for device kind {kind!r} on {platform!r}; "
            f"add a ChipSpec with its source to spgrid/core/roofline.py")
    return spec


def detect_chip() -> ChipSpec:
    """The ChipSpec of the local device; raises on an unknown accelerator."""
    dev = jax.devices()[0]
    return chip_for_kind(dev.platform, dev.device_kind)


def roofline_time(
    flops: float,
    bytes_accessed: float,
    chip: ChipSpec,
    dtype: str = "float32",
) -> float:
    """Speed-of-light time (s): max of compute-bound and memory-bound time.
    NaN on a chip without published peaks."""
    peak = chip.peak_bf16_tflops if dtype == "bfloat16" else chip.peak_f32_tflops
    if math.isnan(peak) or math.isnan(chip.hbm_gbytes_per_s):
        return math.nan
    t_compute = flops / (peak * 1e12) if flops else 0.0
    t_memory = bytes_accessed / (chip.hbm_gbytes_per_s * 1e9) if bytes_accessed else 0.0
    return max(t_compute, t_memory)


def roofline_fraction(
    achieved_time_s: float,
    flops: float,
    bytes_accessed: float,
    chip: ChipSpec,
    dtype: str = "float32",
) -> float:
    """Fraction of speed-of-light attained (1.0 = at the roofline)."""
    sol = roofline_time(flops, bytes_accessed, chip, dtype)
    if achieved_time_s <= 0:
        return 0.0
    return sol / achieved_time_s


def spmm_flops(nnz: int, n: int) -> float:
    """2*nnz*n — the reference flop model for all sparse ops, counted on the
    *original CSR nnz* regardless of format (spmv_bench.cpp:404-408)."""
    return 2.0 * nnz * max(n, 1)


def gemm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def csr_bytes(nnz: int, m: int, n: int, k_cols: int, val_bytes: int = 4,
              idx_bytes: int = 4) -> float:
    """Minimum HBM traffic for CSR SpMM: matrix footprint + dense in/out.

    Matrix footprint formula matches spmv_kernel.h:24:
    ``nnz*(val+idx) + (m+1)*idx``.  Dense traffic counts one streaming read
    of x(k,n) and one write of y(m,n); gathered re-reads push real traffic
    above this, making it a true speed-of-light bound.
    """
    mat = nnz * (val_bytes + idx_bytes) + (m + 1) * idx_bytes
    dense = (k_cols + m) * max(n, 1) * val_bytes if n else 0
    return float(mat + dense)
