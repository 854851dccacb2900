"""Analytic per-kernel SpMM time models + cost-based format selection.

The reference answers "which kernel wins for which structure" empirically
(the whole synthetic-dataset methodology, run.sh sweeps).  Threshold rules
on density/bandwidth miss regime crossovers that depend on more than one
feature — a small-m 100-nnz/row matrix costs almost nothing to densify
(t_dense ∝ m*k*n/rate), so `dense` beats every gather kernel up to
m ≈ rate-bound at densities far below any fixed threshold.  This module
ranks kernels by closed-form time estimates built from measured machine
constants instead.

The constants are one card's table (``C``), measured by
``chip_smoke.py --calibrate``; estimates are coarse (±2x) — they only
need to rank.  Per-format corrections are refittable from sweep CSVs
(`fit_constants`).  Every function takes the table it prices with, so
routing tests pass a table of their own.

Reference counterparts: the per-kernel GFLOPS prediction models in the
paper analysis (results_visualization notebooks) and the format-selection
studies the dataset exists to drive (SURVEY §2.2, §6).
"""

from __future__ import annotations

import dataclasses
import math

from spgrid.features.structural import MatrixFeatures


@dataclasses.dataclass
class ChipConstants:
    """Measured machine constants of one card."""

    eff_bw: float          # streaming copy bytes/s (read + write)
    matmul_f32: float      # f32 matmul flops/s at HIGHEST (no TF32)
    matmul_bf16: float     # bf16 matmul flops/s, f32 accumulation
    gather_fast: float     # X-row gathers/s (n = 512 f32 rows), source
                           # under the gather cliff
    gather_slow: float     # X-row gathers/s, source far above the cliff
    gather_cliff: float    # source bytes where the gather rate falls
                           # (the card's last-level cache)
    combine_bw: float      # multi-stream elementwise+reduce bytes/s
    scoo_scatter: float    # seconds per (row of n = 512) scatter-add entry
    dispatch: float        # fixed per-op seconds inside a jitted call
    source: str = ""
    # per-format multiplicative corrections, refit from sweep CSVs
    # (fit_constants); a format with no entry is uncorrected (1.0)
    fudge: dict = dataclasses.field(default_factory=dict)


# NVIDIA H100 80GB HBM3 at a 400 W power limit, as printed by
# `python chip_smoke.py --calibrate`.  gather_cliff is the card's 50 MB
# L2 (the probes gather from a 16 MB and a 1 GiB source).  dispatch is the
# per-iteration cost of the harness's chained timing loop, which every
# measured row includes.  The fudges are unfitted: every format is priced
# at 1.0 until a refit from H100 rows.
H100_CONSTANTS = ChipConstants(
    eff_bw=3.01e12, matmul_f32=4.956e13, matmul_bf16=7.225e14,
    gather_fast=9.383e8, gather_slow=6.781e8, gather_cliff=50e6,
    combine_bw=3.038e12, scoo_scatter=1.168e-9, dispatch=1.868e-5,
    source="chip_smoke.py --calibrate, NVIDIA H100 80GB HBM3, 400 W",
)

C = H100_CONSTANTS


def _dense_time(f: MatrixFeatures, n: int, flops_rate: float, c) -> float:
    flops = 2.0 * f.m * f.n * n
    bytes_ = 4.0 * (f.m * f.n + f.n * n + f.m * n)
    return max(flops / flops_rate, bytes_ / c.eff_bw)


def _bsr_occupied_blocks(f: MatrixFeatures, clustering_cap: bool = False
                         ) -> float:
    """Estimated occupied 128x128 blocks — shared by _bsr_time and the
    bsr applicability gate (ADVICE r4: one copy, not two that drift).

    Base model: Poisson fill over the band's candidate blocks.
    clustering_cap (ADVICE r4, GATE ONLY): uniform fill overestimates
    occupancy for clustered structure — entries arrive in
    ~(1+avg_num_neighbours)-long column segments repeated over ~1/(1-crs)
    adjacent rows, so each occupied block expects at least that many
    entries; occupied <= nnz / that.  The cap's direction is right for
    the 2GB inapplicability gate (never exclude a runnable clustered
    matrix) but r5 validation showed it WORSENS the time model's ranking
    (medAPE 31 -> 40: local clusters are rarely block-aligned), so
    _bsr_time keeps the uncapped estimate."""
    mb = max(f.m / 128.0, 1.0)
    kb = max(f.n / 128.0, 1.0)
    # blocks that can hold nnz: banded matrices restrict to the band.
    # The band is row bandwidth PLUS diagonal wander (r5: narrow rows
    # scattered across a wide placement range — avg_bw 10 cols but
    # centers spread over ~6k — occupied ~1 block per row-run, 15x the
    # row-bandwidth-only estimate; avg_dd_scaled is the wander feature)
    band = f.avg_bw + 4.0 * getattr(f, "avg_dd_scaled", 0.0) * f.n
    band_kb = min(kb, (band + 256.0) / 128.0)
    cand = mb * band_kb
    lam = f.nnz / max(cand, 1e-9)          # nnz per candidate block
    occ = cand * (1.0 - math.exp(-lam / 1.0))
    if not clustering_cap:
        return occ
    seg = 1.0 + max(f.avg_num_neighbours, 0.0)
    run = 1.0 / max(1.0 - min(f.cross_row_similarity, 1.0), 1.0 / 128.0)
    per_occ = max(1.0, lam, min(seg, 128.0) * min(run, 128.0))
    return min(occ, f.nnz / per_occ)


def _bsr_time(f: MatrixFeatures, n: int, c) -> float:
    """128x128-block Pallas kernel: per occupied block one x-tile load or
    one (128,128)@(128,n) f32 matmul, whichever binds."""
    occ = _bsr_occupied_blocks(f)
    per_block = max(
        128.0 * n * 4 / c.eff_bw,          # x-tile load
        2.0 * 128 * 128 * n / c.matmul_f32,   # f32 block matmul
    )
    return occ * per_block + f.m * n * 4 / c.eff_bw


def _panel_time(f: MatrixFeatures, n: int, c) -> float:
    """Vertical 2048x128 panels: occupied panels run a dense matmul."""
    panels = max(f.m / 2048.0, 1.0) * max(f.n / 128.0, 1.0)
    lam = f.nnz / max(panels, 1e-9)
    occ_frac = 1.0 - math.exp(-lam)
    occupied_area = occ_frac * f.m * f.n
    flops = 2.0 * occupied_area * n
    bytes_ = occupied_area * 4 + occ_frac * panels * (128.0 * n * 4)
    return max(flops / c.matmul_f32, bytes_ / c.eff_bw)


def _gell_windowable(f: MatrixFeatures, bpe: float = 4.0) -> bool:
    """Can row chunks gather from <=63MB X windows?  Approximated from
    the measured bandwidth stats (chunk col span ~ avg_bw + chunk).  The
    cap is source BYTES at n=512 (gell._plan_windows), so bf16-source
    modes (bpe=2) window bands twice as wide."""
    span_cap = (63 << 20) / (bpe * 512.0)
    return f.avg_bw + 2.0 * f.std_bw + 1024 <= span_cap


def _full_src_rate(src_bytes: float, c) -> float:
    """Gather rows/s from a full (unwindowed) X of `src_bytes`.

    The rate falls smoothly past the cliff rather than in a step: the
    model interpolates fast*(cliff/src)^0.9 down to the slow anchor (the
    exponent was fitted on an earlier accelerator; the anchors are the
    card's gather_fast/gather_slow probes)."""
    cap = c.gather_cliff
    if src_bytes <= cap:
        return c.gather_fast
    return max(c.gather_slow, c.gather_fast * (cap / src_bytes) ** 0.9)


def _unfloored_src_rate(src_bytes: float, c) -> float:
    """_full_src_rate without the gather_slow floor: giant sources (e.g.
    the (k, n) f32 X at k ~ 1M) kept degrading past the floor in the rows
    this model was fitted on."""
    cap = c.gather_cliff
    if src_bytes <= cap:
        return c.gather_fast
    return c.gather_fast * (cap / src_bytes) ** 0.9


def residual_per_nnz(n: int, c: ChipConstants) -> float:
    """Seconds per nnz of a gather kernel's work: one X-row gather from an
    under-the-cliff source plus streaming its n f32 products in and out
    (the per-slot terms of the sell/coo models)."""
    return 1.0 / c.gather_fast + 2.0 * n * 4.0 / c.combine_bw


def _gather_rate(f: MatrixFeatures, n: int, bytes_per_elem: float, c) -> float:
    src = f.n * n * bytes_per_elem
    if _gell_windowable(f, bytes_per_elem):
        # windowed gather-reuse credit: when each source row inside a
        # window is hit many times (nnz per source row = avg_nnz * m/k >=
        # ~16), the take runs faster than the flat windowed rate (1.5x in
        # the rows this was fitted on; not yet re-fitted on the H100)
        per_src = f.avg_nnz_per_row * f.m / max(f.n, 1)
        if per_src >= 16.0:
            return c.gather_fast * 1.5
        return c.gather_fast
    return _full_src_rate(src, c)


def _gell_slots_tail(f: MatrixFeatures) -> tuple:
    """(slots, estimated tail nnz) matching GELLMatrix.__init__: slots =
    ceil(1.25*avg) (widened to max when max <= slots+2 holds everything);
    tail = the skew-boosted row's overflow (gen/artificial.py realizes
    skew by boosting ONE row to avg*(1+skew) nnz) + a normal-approximation
    expected per-row overflow E[(deg-slots)+] from (avg, std)."""
    slots = max(1.0, math.ceil(f.avg_nnz_per_row * 1.25))
    mx = min(f.avg_nnz_per_row * (1.0 + max(f.skew, 0.0)), float(f.n))
    if mx <= slots + 2:
        return max(1.0, mx), 0.0
    tail = max(0.0, mx - slots)
    mu, sd = f.avg_nnz_per_row, max(f.std_nnz_per_row, 1e-9)
    z = (slots - mu) / sd
    phi = math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    tail += max(0.0, sd * phi - (slots - mu) * (1.0 - cdf)) * f.m
    return slots, min(tail, 0.9 * f.nnz)


def _gell_time(f: MatrixFeatures, n: int, mode: str, c) -> float:
    """Gather-ELL (ops/gell.py): windowed row gather + slot combine.

    Gather throughput is rows/s bounded and higher when the gather
    source is under the cliff — which windowing achieves for column-local
    matrices.  Plus the windowed gather-reuse credit (see _gather_rate) and
    a tail term — tail nnz (skew-boosted row + distribution overflow,
    _gell_slots_tail) gather from the FULL f32 X (gell.py::_add_tail
    takes from x, never a window) at the unfloored smooth rate."""
    slots, tail = _gell_slots_tail(f)
    rows_g = f.m * slots
    if mode == "bf16":
        bpe, planes = 2.0, 1
    elif mode == "split16":
        bpe, planes = 2.0, 2
    elif mode == "split24":
        bpe, planes = 2.0, 3
    else:
        bpe, planes = 4.0, 1
    convert = 0.0 if mode == "f32" else f.n * n * (4.0 + bpe * planes) \
        / c.eff_bw
    # gather throughput is ROWS/S bounded: split16 concatenates [hi|lo]
    # into one 2n-wide bf16 source (ONE take); only split24 pays a second
    # take for its lo plane.  Source bytes/elem-of-n (the cliff/window
    # quantity) is therefore 4 for f32/split modes and 2 only for bf16 —
    # bf16 mode windows bands twice as wide.
    takes = 2.0 if mode == "split24" else 1.0
    src_bpe = 2.0 if mode == "bf16" else 4.0
    gather = takes * rows_g / _gather_rate(f, n, src_bpe, c)
    if mode == "f32":
        # windowed f32 combines as a block-diagonal matmul
        # (WIN_F32_COMBINE, HIGHEST): the gathered intermediate reads
        # back at streaming rate; the direct (small-k) path keeps the
        # elementwise combine but is gather-dominated there
        combine = (rows_g * n * 4.0 + f.m * n * 4.0) / c.eff_bw \
            + 6.0 * 16.0 * rows_g * n / c.matmul_bf16
    else:
        # block-diagonal matmul combine: the gathered intermediate is
        # written once and streamed back into the matmul at full
        # bandwidth; its flops are small next to the bf16 matmul rate
        nv = 3 if mode == "split24" else 2
        g_bytes = planes * rows_g * n * bpe * 2.0 + f.m * n * 4.0
        mxu = 16.0 * rows_g * n * planes * nv / c.matmul_bf16
        combine = g_bytes / c.eff_bw + mxu
    t_tail = tail / _unfloored_src_rate(f.n * n * 4.0, c) \
        + tail * n * 4.0 * 2.0 / c.eff_bw
    return convert + gather + combine + t_tail


def _ell_time(f: MatrixFeatures, n: int, c) -> float:
    width = max(f.max_nnz_per_row, 1)
    # the stock XLA ELL path never windows and measured the full slow
    # rate already just past the cliff (its padded (m, width) gather
    # pattern — unlike merge/sell whose smooth interpolation fits), so it
    # keeps the step model
    rate = c.gather_fast if f.n * n * 4 <= c.gather_cliff else c.gather_slow
    return f.m * width / rate \
        + (f.m * width * n * 4 + f.m * n * 4) / c.combine_bw


def _coo_time(f: MatrixFeatures, n: int, c) -> float:
    rate = _full_src_rate(f.n * n * 4.0, c)
    return f.nnz / rate \
        + (3.0 * f.nnz * n * 4 + f.m * n * 4) / c.combine_bw


def _scoo_time(f: MatrixFeatures, n: int, c) -> float:
    """Column-windowed COO (ops/scoo.py): every gather runs at the fast
    (<64MB-source) rate; the combine is an in-place sorted scatter-add.

    Padded entry count: blocks are (R=32k rows, W=32k cols); per-block
    population ~ Poisson(mu), padded to the max block, approximated
    mu + 3*sqrt(mu) + skew allowance."""
    R = W = 1 << 15
    nb = max(math.ceil(f.m / R), 1)
    ns = max(math.ceil(f.n / W), 1)
    mu = f.nnz / (nb * ns)
    # banded matrices concentrate entries in diagonal blocks: the max
    # block then carries ~ns/band_blocks times the mean
    band_ns = min(ns, max(f.avg_bw / W, 1.0 / ns))
    conc = min(ns / max(band_ns, 1e-9), ns)
    e_pad = mu * conc + 3.0 * math.sqrt(max(mu * conc, 1.0)) + 8
    nnz_pad = nb * ns * e_pad
    gather = nnz_pad / c.gather_fast
    combine = nnz_pad * c.scoo_scatter
    stream = (f.m * n * 4.0 + nnz_pad * n * 4.0) / c.eff_bw
    return gather + combine + stream


def _merge_time(f: MatrixFeatures, n: int, c) -> float:
    """Merge-path equal-nnz blocks (ops/merge.py): per nnz the kernel pays
    a 128-tall one-hot MXU product (2*128*n flops), the one-hot + gathered
    operand traffic (~5KB), and an unsorted segment-sum over B*128 strip
    rows — skew-proof by construction, never cheap (VERDICT r2 weak #6
    asked for the honest model + measurement)."""
    T = 512.0
    blocks = max(f.nnz / T, f.m / 128.0, 1.0)
    # merge always gathers from the FULL X (never windowed), so the
    # gell-only windowed fast-gather credit of _gather_rate does not
    # apply — smooth full-source cliff (see _full_src_rate)
    gather = f.nnz / _full_src_rate(f.n * n * 4.0, c)
    mxu = blocks * 2.0 * 128.0 * T * n / c.matmul_f32
    onehot_bytes = blocks * 128.0 * T * 4.0 * 2.0
    g_bytes = blocks * T * n * 4.0 * 2.0
    seg_bytes = blocks * 128.0 * n * 4.0 * 2.0 + f.m * n * 4.0
    return gather + mxu         + (onehot_bytes + g_bytes + seg_bytes) / c.eff_bw


def _sell_time(f: MatrixFeatures, n: int, c) -> float:
    """SELL-C-sigma SpMM (ops/xla.py::spmm_sell): sigma-sorting keeps slot
    padding small, but the gather source is the full X (never windowed)
    and the permutation costs two extra (m, n) scatter passes.

    Skew term (r5 fix, VERDICT r4 weak #1): measured sell rows run
    1.3-1.7x slower than the flat model at skew >= ~100 (medium_study +
    newkernels rows) — skewed degree spreads the width buckets, so the
    widest slices pad more and the per-bucket dispatch multiplies;
    merge is skew-proof by construction and the flat model ranked them
    as equals inside the scattered class."""
    slots = 1.1 * f.nnz + 32.0 * f.m / 8.0
    rate = _full_src_rate(f.n * n * 4.0, c)
    skew_pen = 1.0 + 0.125 * math.log10(1.0 + max(f.skew, 0.0))
    return skew_pen * (slots / rate
                       + (slots * n * 4.0 + 3.0 * f.m * n * 4.0)
                       / c.combine_bw)


def _rbh_time(f: MatrixFeatures, n: int, c) -> float:
    """Reorder-block hybrid (ops/rbh.py): per-call X column-perm gather +
    dense block passes over the clustered fraction + gather residual.

    Clusterability model (a property of the inspector, not the device):
    the inspect step packs hi_frac ~ 0.74 * crs of the nnz into blocks of
    fill ~ 90 * run^0.42 nnz, where run = 1/(1-crs) is the column-reuse
    row-run length; the residual is the non-local tail.
    - density branch: when the UNCLUSTERED expected block fill
      density*128^2 already clears the admission threshold (~32 nnz), the
      inspector keeps essentially every block (hi_frac -> 1).
    - boosted-row densification: the skew-boosted row (gen realizes skew
      as ONE row of avg*(1+skew) nnz) has ~128*b/k nnz per 128-col window;
      past the threshold it densifies into ~k/128 blocks instead of
      riding the residual.
    - MAX_HI_BLOCKS budget (rbh.py: 2GB / 64KB = 32768 blocks) caps the
      dense split; the spill returns to the residual.
    - per-block cost x0.6: vertically-adjacent blocks in one column
      window share their (128, n) x-tile, so the worst-case per-block
      accounting overcharges clustered splits (fitted on an earlier
      accelerator; unfitted on the H100).
    - perm gather at the unfloored smooth rate."""
    run = 1.0 / max(1.0 - min(f.cross_row_similarity, 0.999), 1.0 / 128.0)
    clus_fill = 90.0 * min(run, 128.0) ** 0.42
    base_fill = f.density * 16384.0
    thresh = 32.0
    if base_fill >= thresh:
        hi_frac, fill = 1.0, max(base_fill, clus_fill)
    else:
        hi_frac, fill = min(1.0, 0.74 * f.cross_row_similarity), clus_fill
    hi_nnz = hi_frac * f.nnz
    extra_blocks = 0.0
    boost = min(f.avg_nnz_per_row * (1.0 + max(f.skew, 0.0)), float(f.n))
    if f.skew > 0 and boost > 4.0 * f.avg_nnz_per_row \
            and 128.0 * boost / max(f.n, 1) >= thresh:
        hi_nnz += boost * (1.0 - hi_frac)
        extra_blocks = f.n / 128.0
    blocks = hi_nnz / max(fill, 1.0) + extra_blocks
    max_blocks = float((2 << 30) // (128 * 128 * 4))
    if blocks > max_blocks:
        hi_nnz -= (blocks - max_blocks) * fill
        blocks = max_blocks
    per_block = max(128.0 * n * 4 / c.eff_bw,
                    2.0 * 128 * 128 * n / c.matmul_f32)
    perm = f.n / _unfloored_src_rate(f.n * n * 4.0, c)
    res = (f.nnz - hi_nnz) * residual_per_nnz(n, c)
    stream = f.m * n * 4.0 / c.eff_bw
    return perm + blocks * per_block * 0.6 + res + stream


def _fudged(fmt: str, t: float, c) -> float:
    return t * c.fudge.get(fmt, 1.0)


def estimate_spmm_time(f: MatrixFeatures, fmt: str, n: int,
                       consts: "ChipConstants | None" = None) -> float:
    """Seconds for one SpMM call of `fmt` on a matrix with features `f`.

    Returns +inf for formats that are inapplicable (would OOM / wrong n).
    ``consts`` defaults to the card's table ``C``.
    """
    c = consts or C
    if fmt == "dense":
        if f.m * f.n * 4 > (1 << 31):
            return math.inf
        return _fudged(fmt, _dense_time(f, n, c.matmul_f32, c), c) + c.dispatch
    if fmt in ("bsr_pallas", "bsr"):
        # occupied blocks materialize DENSELY (128x128x4B each): a
        # scattered 137k-row matrix occupies ~nnz blocks -> ~190GB and
        # the conversion wedges the host (r4 medium-study stall) — the
        # format is inapplicable long before the time model says slow
        if _bsr_occupied_blocks(f, clustering_cap=True) * 128 * 128 * 4 \
                > (1 << 31):
            return math.inf
        return _fudged(fmt, _bsr_time(f, n, c), c) + c.dispatch
    if fmt in ("panel", "cv_panel"):
        est_panel_bytes = min(1.0, f.density * 2048 * 128) * f.m * f.n * 4
        if est_panel_bytes > (1 << 31):
            return math.inf
        return _fudged(fmt, _panel_time(f, n, c), c) + c.dispatch
    if fmt == "gell":
        return _fudged(fmt, _gell_time(f, n, "f32", c), c) + c.dispatch
    if fmt == "gell16":
        return _fudged(fmt, _gell_time(f, n, "split16", c), c) + c.dispatch
    if fmt == "cv_gell":
        return _fudged(fmt, _gell_time(f, n, "bf16", c), c) + c.dispatch
    if fmt == "ell":
        slots_est = f.m * max(f.max_nnz_per_row, 1)
        if slots_est > 32 * max(f.nnz, 1) and slots_est * 8 > (64 << 20):
            return math.inf
        return _fudged(fmt, _ell_time(f, n, c), c) + c.dispatch
    if fmt == "coo":
        return _fudged(fmt, _coo_time(f, n, c), c) + c.dispatch
    if fmt == "scoo":
        return _fudged(fmt, _scoo_time(f, n, c), c) + c.dispatch
    if fmt == "merge":
        return _fudged(fmt, _merge_time(f, n, c), c) + c.dispatch
    if fmt == "sell":
        return _fudged(fmt, _sell_time(f, n, c), c) + c.dispatch
    if fmt == "rbh":
        # densified-block budget: the hybrid caps itself at 2GB of blocks
        # (rbh.MAX_HI_BLOCKS), so it is always *runnable*; inapplicable
        # only where there is nothing to cluster (no reuse signal)
        if f.cross_row_similarity <= 0.0 and f.avg_num_neighbours <= 0.0:
            return math.inf
        return _fudged(fmt, _rbh_time(f, n, c), c) + c.dispatch
    return math.inf


# Default candidate set for f32-exact cost-based auto dispatch (CV modes
# trade accuracy and are opted into explicitly).  The admissions were
# decided by measured head-to-heads and model-validation tables
# (scripts/refit_costmodel.py) on an earlier accelerator; none is
# re-validated on the H100 yet (PERF.md, Open questions):
# - merge: the skew-proof kernel of the skewed-row regime the reference
#   covers with merge-based SpMV (spmv_kernel_merge.cpp:61-65).
# - sell: the scattered-hypersparse class.
# - rbh: the clustered-scattered class (MKL-IE structure reuse).
# - out: scoo (lost every head-to-head in its class) and ell (dominated
#   by gell = ELL + window plan + skew tail); both stay explicit kernels.
AUTO_CANDIDATES = ("dense", "bsr_pallas", "panel", "gell",
                   "coo", "merge", "sell", "rbh")

# SpMV (n = 1) candidates: the XLA gather family, ranked by the same models.
SPMV_CANDIDATES = ("coo", "sell", "merge", "gell")


def _finite_or_zero(v) -> float:
    try:
        v = float(v)
    except (TypeError, ValueError):
        return 0.0
    return v if math.isfinite(v) else 0.0


def prediction_records(df) -> list:
    """Per-row measured-vs-predicted model validation records.

    For every oracle-passing fixed-kernel row in `df` (merged result
    frame) with full feature columns, reconstruct the MatrixFeatures the
    dispatcher would see and evaluate the analytic model.  Returns dicts
    with fmt, matrix_name, n, measured/predicted time, their ratio, and
    the structure features the models key on — the raw material for both
    fit_constants and the per-format validation tables (VERDICT r3 item
    6: no auto row steered by an unvalidated model).
    """
    import numpy as np  # noqa: F811

    from spgrid.features.structural import MatrixFeatures

    records: list = []
    need = ["fmt", "time", "csr_m", "csr_k", "csr_nnz", "input_columns",
            "avg_nnz_per_row", "std_nnz_per_row", "avg_bw_scaled",
            "std_bw_scaled", "skew"]
    if any(c not in df.columns for c in need):
        return records
    sub = df
    if "errors_passed" in df.columns:
        sub = df[df["errors_passed"] == 1]
    for _, r in sub.iterrows():
        fmt = r["fmt"]
        if any(not np.isfinite(float(r.get(c) if r.get(c) is not None
                                     else float("nan")))
               for c in need if c not in ("fmt",)):
            continue          # pipeline/sddmm rows lack feature columns
        m, k = int(r["csr_m"]), int(r["csr_k"])
        bw = float(r["avg_bw_scaled"]) * k
        f = MatrixFeatures(
            name="", m=m, n=k, nnz=int(r["csr_nnz"]),
            density=float(r["csr_nnz"]) / max(m * k, 1),
            mem_footprint=0.0, mem_range="",
            avg_nnz_per_row=float(r["avg_nnz_per_row"]),
            std_nnz_per_row=float(r["std_nnz_per_row"]),
            min_nnz_per_row=0,
            max_nnz_per_row=int(float(r["avg_nnz_per_row"])
                                * (1 + float(r["skew"]))),
            avg_bw=bw, std_bw=float(r["std_bw_scaled"]) * k,
            avg_bw_scaled=float(r["avg_bw_scaled"]),
            std_bw_scaled=float(r["std_bw_scaled"]),
            avg_sc=0.0, std_sc=0.0, avg_sc_scaled=0.0, std_sc_scaled=0.0,
            skew=float(r["skew"]),
            # clustering features steer the rbh/bsr models — carry them
            # when the row has them (r5; they default to 0 on old rows)
            avg_num_neighbours=_finite_or_zero(r.get("avg_num_neighbours")),
            cross_row_similarity=_finite_or_zero(
                r.get("cross_row_similarity")))
        pred = estimate_spmm_time(f, fmt, int(r["input_columns"]))
        if math.isfinite(pred) and pred > 0 and float(r["time"]) > 0:
            records.append(dict(
                fmt=fmt, matrix_name=r.get("matrix_name", ""),
                n=int(r["input_columns"]), time=float(r["time"]),
                pred=pred, ratio=float(r["time"]) / pred,
                m=m, nnz=int(r["csr_nnz"]),
                avg_bw_scaled=float(r["avg_bw_scaled"]),
                skew=float(r["skew"]),
                source=r.get("source", "")))
    return records


def fit_constants(df, *, min_rows: int = 3) -> dict:
    """Refit per-format corrections from measured sweep rows.

    `df` is a merged result frame (viz.dataset.merge_result_csvs) with
    fixed-kernel rows.  For each format with >= min_rows oracle-passing
    rows, the median measured/predicted time ratio becomes a
    multiplicative correction applied by estimate_spmm_time — the
    reference's empirical-sweep -> model-refit loop (SURVEY §6) with the
    analytic forms as the basis.  Returns the fitted corrections (also
    installed into the live constants).
    """
    import numpy as np  # noqa: F811

    ratios: dict = {}
    for rec in prediction_records(df):
        ratios.setdefault(rec["fmt"], []).append(rec["ratio"])
    fitted = {fmt: float(np.median(v)) for fmt, v in ratios.items()
              if len(v) >= min_rows}
    # apply on top of any existing correction (pred already includes it)
    for fmt, rr in fitted.items():
        C.fudge[fmt] = C.fudge.get(fmt, 1.0) * rr
    return fitted


# Value-compressed candidates for tolerance-enabled dispatch (r5): the
# reference's value-compression study (lib/bitstream.c, CV modes) is an
# explicit accuracy trade — offered only when the caller states a
# tolerance at or above the bf16-X representation error (~2^-8).
CV_TOLERANCE = 4e-3


def tolerant_candidates(f: MatrixFeatures, n: int) -> tuple:
    cands = ["cv_panel"]
    # cv_gell regime gate (ROADMAP r4 item 4): the giant-m windowed rows
    # (m >= ~200k, bf16-windowable band) mispredict 2.5-4.7x — exclude
    # exactly that regime so the least-validated model cannot steer
    # tolerance dispatch where it is known to be wrong
    if not (f.m >= 200_000 and _gell_windowable(f, 2.0)):
        cands.append("cv_gell")
    return tuple(cands)


def select_format_cost(f: MatrixFeatures, n: int = 512,
                       candidates=AUTO_CANDIDATES,
                       tolerance: float = 0.0,
                       consts: "ChipConstants | None" = None) -> str:
    """argmin of the analytic time models over applicable formats.

    tolerance >= CV_TOLERANCE additionally offers the value-compressed
    kernels (the accuracy bar is then the dequantized gold, see
    bench/harness.py oracle classes)."""
    cands = tuple(candidates)
    if tolerance >= CV_TOLERANCE:
        cands = cands + tolerant_candidates(f, n)
    best, best_t = None, math.inf
    for fmt in cands:
        t = estimate_spmm_time(f, fmt, n, consts)
        if t < best_t:
            best, best_t = fmt, t
    if best is None:
        return "coo"
    return best
