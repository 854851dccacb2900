"""Format selection: heuristic dispatch + measured autotune.

The reference studies exactly this question — which format/kernel wins for
which structural features (the whole synthetic-dataset methodology).  Here
the selection is a first-class API (BASELINE.json config 4: "Format
autotune: CSR/COO/BSR/sliced-ELL selection across skew/bandwidth grid").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.core.timing import time_kernel
from spgrid.features.structural import MatrixFeatures, matrix_features
from spgrid.formats.csr import CSRMatrix
from spgrid.ops import xla as xops
from spgrid.ops.layouts import (
    DeviceCOO, DeviceELL, DeviceBSR, DeviceSELL, DeviceCSC, DeviceLDU,
    DeviceCV,
)
from spgrid.ops.pallas.bsr_spmm import bsr_spmm
from spgrid.ops.panels import DevicePanels, panel_spmm
from spgrid.ops.gell import DeviceGELL, gell_spmm
from spgrid.ops.merge import DeviceMerge, merge_spmm
from spgrid.ops.scoo import DeviceSCOO, scoo_spmm
from spgrid.ops.rbh import DeviceRBH, rbh_spmm

FORMATS = ("dense", "bsr_pallas", "panel", "bsr", "ell", "sell", "coo",
           "csc", "ldu", "cv_bf16", "cv_int8", "cv_panel", "gell", "gell16",
           "cv_gell", "merge", "scoo", "rbh")


def select_format(f: MatrixFeatures, n: int = 512,
                  dense_limit_bytes: int = 1 << 31,
                  tolerance: float = 0.0, consts=None) -> str:
    """Format selection for `auto` dispatch: argmin of the analytic
    per-kernel time models (ops/costmodel.py) over the applicable
    candidates — the XLA gather family for SpMV (n = 1).  Threshold heuristics miss regime
    crossovers that depend on more than one feature (small-m dense,
    large-m gather regimes); the cost model ranks them directly.

    tolerance: stated acceptable relative error; at >= costmodel.
    CV_TOLERANCE (~bf16 X representation) the value-compressed kernels
    join the candidate set (the reference's CV study trade, explicit).
    """
    from spgrid.ops.costmodel import (
        AUTO_CANDIDATES, SPMV_CANDIDATES, select_format_cost)
    cands = SPMV_CANDIDATES if n == 1 else AUTO_CANDIDATES
    return select_format_cost(f, n, candidates=cands, tolerance=tolerance,
                              consts=consts)


def build(csr: CSRMatrix, fmt: str, *, bm: Optional[int] = None,
          bk: int = 128):
    """Materialize the device operand for a format name.

    bm=None picks the per-format default: 128 for the Pallas BSR kernel
    (each X tile it loads feeds a full block of output rows), 8 for the
    XLA einsum path (keeps the gathered (nb, bk, n) intermediate small)."""
    if fmt == "dense":
        return jnp.asarray(csr.to_dense())
    if fmt in ("bsr", "bsr_pallas"):
        if bm is None:
            bm = 128 if fmt == "bsr_pallas" else 8
        return DeviceBSR.from_csr(csr, bm=bm, bk=bk)
    if fmt == "panel":
        return DevicePanels.from_csr(csr, bk=bk)
    if fmt == "ell":
        return DeviceELL.from_csr(csr)
    if fmt == "sell":
        return DeviceSELL.from_csr(csr)
    if fmt == "coo":
        return DeviceCOO.from_csr(csr)
    if fmt == "csc":
        return DeviceCSC.from_csr(csr)
    if fmt == "ldu":
        from spgrid.formats.ldu import csr_to_ldu
        return DeviceLDU.from_ldu(csr_to_ldu(csr))
    if fmt in ("cv_bf16", "cv_int8"):
        return DeviceCV.from_csr(csr, mode=fmt.split("_")[1])
    if fmt == "cv_panel":
        # CV substrate in the panel layout: bf16 panels halve the dominant
        # panel stream
        import dataclasses as _dc
        p = DevicePanels.from_csr(csr, bk=bk)
        return _dc.replace(p, panels=p.panels.astype(jnp.bfloat16))
    if fmt == "gell":
        # exact f32; gathers through band windows when the structure is
        # column-local
        return DeviceGELL.from_csr(csr, mode="f32")
    if fmt == "gell16":
        return DeviceGELL.from_csr(csr, mode="split16")
    if fmt == "cv_gell":
        return DeviceGELL.from_csr(csr, mode="bf16")
    if fmt == "merge":
        return DeviceMerge.from_csr(csr)
    if fmt == "scoo":
        # column-windowed COO: every gather source is a bounded window of
        # X even when the structure is scattered (ops/scoo.py)
        return DeviceSCOO.from_csr(csr)
    if fmt == "rbh":
        # reorder-block hybrid: column-cluster reorder into dense block
        # tiles + gather residual (ops/rbh.py; the MKL-IE structure-reuse
        # regime, spmm_kernel_mkl_ie.cpp:75-104)
        return DeviceRBH.from_csr(csr)
    raise ValueError(f"unknown format {fmt!r}")


def spmm_fn(fmt: str) -> Callable:
    return {
        "dense": xops.spmm_dense,
        "bsr_pallas": bsr_spmm,
        "panel": panel_spmm,
        "bsr": xops.spmm_bsr,
        "ell": xops.spmm_ell,
        "coo": xops.spmm_coo,
        "csc": xops.spmm_csc,
        "sell": xops.spmm_sell,
        "ldu": xops.spmm_ldu,
        "cv_bf16": xops.spmm_cv,
        "cv_int8": xops.spmm_cv,
        "cv_panel": panel_spmm,
        "gell": gell_spmm,
        "gell16": gell_spmm,
        "cv_gell": gell_spmm,
        "merge": merge_spmm,
        "scoo": scoo_spmm,
        "rbh": rbh_spmm,
    }[fmt]


@dataclasses.dataclass
class AutotuneResult:
    best: str
    times: Dict[str, float]     # seconds per iteration (inf = failed/skipped)


def autotune_spmm(
    csr: CSRMatrix,
    x: jax.Array,
    candidates=None,
    *,
    warmup_iters: int = 3,
    min_time_s: float = 0.05,
    min_iters: int = 5,
    dense_limit: int = 1 << 26,
) -> AutotuneResult:
    """Measure each candidate and return the fastest (ref methodology:
    empirical kernel x matrix sweeps; here condensed to a per-matrix tune —
    the inspector-executor discipline of mkl_sparse_optimize,
    spmm_kernel_mkl_ie.cpp:75-104).

    Candidates default to the cost model's AUTO_CANDIDATES (r4 admissions:
    gell/merge/sell included) so measured dispatch can pick every kernel
    cost-based dispatch can; inapplicable formats (cost model +inf — e.g.
    dense at 256GB, bsr with densifying blocks) are skipped, not timed."""
    from spgrid.ops.costmodel import AUTO_CANDIDATES, estimate_spmm_time
    if candidates is None:
        candidates = AUTO_CANDIDATES
    feats = matrix_features(csr)
    n_cols = x.shape[1] if x.ndim == 2 else 1
    times: Dict[str, float] = {}
    for fmt in candidates:
        if fmt == "dense" and csr.m * csr.k > dense_limit:
            times[fmt] = float("inf")
            continue
        if not np.isfinite(estimate_spmm_time(feats, fmt, n_cols)):
            times[fmt] = float("inf")
            continue
        try:
            a = build(csr, fmt)
            fn = spmm_fn(fmt)
            r = time_kernel(lambda: fn(a, x), warmup_iters=warmup_iters,
                            min_time_s=min_time_s, min_iters=min_iters)
            times[fmt] = r.time_per_iter_s
        except Exception:
            times[fmt] = float("inf")
    best = min(times, key=times.get)
    if times[best] == float("inf"):
        # every candidate failed/was skipped: returning one anyway would
        # make the caller build a format autotune refused to even measure
        raise RuntimeError(
            f"autotune: no runnable candidate among {list(times)}")
    return AutotuneResult(best=best, times=times)
