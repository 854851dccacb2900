"""Validation-twin sensitivity analysis + figure (VERDICT r1 item 4).

Consumes benchmark_results/h100/validation_twins.csv (run_validation_
twins.py): for each validation matrix, the base feature-exact twin plus
+-30% sweeps of avg_nnz_per_row and bw. Emits the APE of each swept twin
vs its base (the reference's validation-vs-twin APE methodology,
validation_plotter-SPLITTING.ipynb, applied to the stand-in twins — real
matrices unreachable on this zero-egress box, stated in the CSV) and a
per-matrix GFLOPS bar figure.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd

RES = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100")


def main():
    df = pd.read_csv(os.path.join(RES, "validation_twins.csv"))
    base = df[df.matrix_name.str.endswith("_twin")].copy()
    base["mat"] = base.matrix_name.str[:-5]
    swept = df[~df.matrix_name.str.endswith("_twin")].copy()
    swept["mat"] = swept.matrix_name.str.extract(r"^(.*)_twin_")[0]
    merged = swept.merge(base[["mat", "gflops", "fmt"]], on="mat",
                         suffixes=("", "_base"))
    merged["ape"] = ((merged.gflops - merged.gflops_base).abs()
                     / merged.gflops_base * 100)
    out = merged[["matrix_name", "mat", "fmt", "fmt_base", "gflops",
                  "gflops_base", "ape"]]
    out.to_csv(os.path.join(RES, "validation_twin_ape.csv"), index=False)
    print(out.to_string(index=False))
    print(f"\nMAPE across feature sweeps: {merged.ape.mean():.1f}%")

    fig, ax = plt.subplots(figsize=(11, 4.5))
    mats = base.sort_values("gflops").mat
    ax.bar(range(len(mats)), base.set_index("mat").loc[mats, "gflops"],
           color="#d62728", label="base twin (auto)")
    for i, mt in enumerate(mats):
        sw = merged[merged.mat == mt].gflops
        if len(sw):
            ax.scatter([i] * len(sw), sw, color="#333333", s=12, zorder=3,
                       label="±30% feature twins" if i == 0 else None)
    ax.set_xticks(range(len(mats)))
    ax.set_xticklabels(mats, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("GFLOPS (auto dispatch, n=512, f32)")
    ax.set_title("Validation-twin study on the H100: base twins vs ±30% feature"
                 " perturbations")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(RES, "validation_twins.png"), dpi=120)
    print("wrote validation_twin_ape.csv + validation_twins.png")

    # r5 calibrated leg (VERDICT r4 item 8): compare twin-feature fidelity
    # calibrated vs uncalibrated — avg_nnz hits the target exactly under
    # calibration at a stated crs/neigh cost; report the feature errors
    # and the GFLOPS shift side by side.
    cal_path = os.path.join(RES, "validation_twins_cal.csv")
    if os.path.exists(cal_path):
        cal = pd.read_csv(cal_path)
        calb = cal[cal.matrix_name.str.endswith("_twin")].copy()
        calb["mat"] = calb.matrix_name.str[:-5]
        cmp_ = base.merge(calb, on="mat", suffixes=("_uncal", "_cal"))
        cols = ["mat", "gflops_uncal", "gflops_cal",
                "avg_nnz_per_row_uncal", "avg_nnz_per_row_cal",
                "cross_row_similarity_uncal", "cross_row_similarity_cal",
                "fmt_uncal", "fmt_cal"]
        cols = [c for c in cols if c in cmp_.columns]
        out2 = cmp_[cols]
        out2.to_csv(os.path.join(RES, "validation_twin_fidelity.csv"),
                    index=False)
        print(out2.to_string(index=False))
        print("wrote validation_twin_fidelity.csv")


if __name__ == "__main__":
    main()
