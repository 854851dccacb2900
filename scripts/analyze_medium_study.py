"""Medium-study analysis: dispatch accuracy + per-regime summary + figure.

Consumes benchmark_results/h100/medium_study.csv (run_medium_study.py):
- dispatch_accuracy: % of portfolio matrices where `auto` lands within 10%
  of the best fixed kernel (the number VERDICT r1 asked for;
  viz/dataset.py::dispatch_accuracy)
- per-regime GFLOPS summary (hypersparse / mid / dense-ish by avg nnz/row)
- a density-vs-GFLOPS scatter colored by the dispatched format

Reference counterpart: the master-plotter synthetic-dataset analyses
(results_visualization/master_plotter_synthetic.ipynb).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import matplotlib  # noqa: E402
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402

from spgrid.viz.dataset import dispatch_accuracy  # noqa: E402

RES = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100")

# entity-stable categorical colors (validated default palette slots):
# one hue per dispatched format family, fixed assignment
FMT_COLORS = {
    "dense": "#2a78d6", "bsr_pallas": "#eb6834", "panel": "#1baf7a",
    "gell": "#eda100", "scoo": "#008300",
    "ell": "#4a3aa7", "coo": "#e34948", "merge": "#7a4ad6",
    "sell": "#13a0a8", "rbh": "#a05a2c",
}


def main():
    # prefer the full study; fall back to the committed medium slices
    # (r2 vintage, same schema) so the analysis runs on whatever medium
    # rows exist rather than requiring the complete 500-matrix study
    # r4auto first: re-measured auto rows under the round-4 dispatch
    # (merge/sell admitted) take precedence over stale pre-admission
    # auto rows for the same matrix in the older CSVs
    paths = [os.path.join(RES, p) for p in
             ("medium_study_r5auto.csv",
              "medium_study_r4auto.csv", "medium_study.csv",
              "medium_slice_auto.csv", "medium_spread_auto.csv",
              "medium_spread_r2.csv", "medium_spread_r2_refresh.csv",
              "medium_spread_r3_refresh.csv")]
    frames = [pd.read_csv(p) for p in paths if os.path.exists(p)]
    if not frames:
        print("no medium rows yet"); return
    df = pd.concat(frames, ignore_index=True) \
        .drop_duplicates(subset=["matrix_name", "kernel", "input_columns"])
    print(f"{len(df)} medium rows from "
          f"{sum(os.path.exists(p) for p in paths)} CSVs")
    ok = df[df.get("errors_passed", 1) == 1]

    acc, rows = dispatch_accuracy(ok, include_lossy=False)
    print(f"dispatch accuracy (auto within 10% of best LOSSLESS fixed): "
          f"{acc*100:.1f}% over {len(rows)} portfolio matrices")
    acc_tol, rows_tol = dispatch_accuracy(ok, include_lossy=True)
    print(f"tolerance-enabled headroom (cv_* in portfolio): "
          f"{acc_tol*100:.1f}% over {len(rows_tol)} — the gap is what an "
          f"explicit cv opt-in buys, not a dispatch miss")
    for name, a, best, okk in rows:
        if not okk:
            print(f"  MISS {name[:60]}: auto {a:.1f} vs best {best:.1f} GF")

    auto = ok[ok.kernel == "auto"].dropna(subset=["gflops"]).copy()
    bins = pd.cut(auto.avg_nnz_per_row, [0, 16, 64, 1e9],
                  labels=["hypersparse (<=16/row)", "mid (17-64/row)",
                          "dense-ish (>64/row)"])
    summ = auto.groupby(bins, observed=True).gflops \
        .agg(["count", "median", "mean", "max"])
    print(summ.to_string())
    summ.to_csv(os.path.join(RES, "medium_study_summary.csv"))
    with open(os.path.join(RES, "medium_study_summary.csv"), "a") as f:
        f.write(f"# dispatch_accuracy,{acc:.4f},n={len(rows)}\n")
        f.write(f"# dispatch_accuracy_with_cv,{acc_tol:.4f},"
                f"n={len(rows_tol)}\n")

    fig, ax = plt.subplots(figsize=(8, 5))
    for fmt, g in auto.groupby("fmt"):
        dens = g.csr_nnz / (g.csr_m * g.csr_k)
        ax.scatter(dens, g.gflops, s=14, label=f"{fmt} (n={len(g)})",
                   color=FMT_COLORS.get(fmt, "#888888"))
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("density (nnz / m·k)")
    ax.set_ylabel("GFLOPS (sparse-accounted, auto dispatch)")
    ax.set_title(f"Medium synthetic study on the H100 — auto dispatch "
                 f"({len(auto)} matrices, accuracy {acc*100:.0f}%)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(RES, "medium_study.png"), dpi=120)
    print("wrote medium_study_summary.csv + medium_study.png")


if __name__ == "__main__":
    main()
