"""SDDMM planner A/B: measured speedup vs the occupancy model's estimate.

VERDICT r3 weak #5 / item 4: the occupancy planner (ops/sddmm_plan.py)
rewired run_sddmm's blocking on a model-only 1.59-1.72x estimate.  This
joins the measured A/B arms from sddmm_study.csv (plan vs fixed 128x128,
per mask type x sparsity x precision) against sddmm_occupancy.csv's
est_speedup_vs_128 and commits the comparison — the planner keeps its
role only where the measured column confirms it.

Output: benchmark_results/h100/sddmm_planner_ab.csv + stdout table.
"""
from __future__ import annotations

import csv
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

RES = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100")


def main():
    rows = list(csv.DictReader(open(os.path.join(RES, "sddmm_study.csv"))))
    occ = {(r["mask_type"], float(r["sparsity"])): r
           for r in csv.DictReader(
               open(os.path.join(RES, "sddmm_occupancy.csv")))}
    pat = re.compile(
        r"mask_(\d+)_(band_and_\w+?)_sp([\d.]+)_(highest|high)(_b128)?$")
    by_arm: dict = {}
    for r in rows:
        m = pat.match(r["matrix_name"])
        if not m:
            continue
        length, mtype, sp, prec, fixed = m.groups()
        key = (mtype, float(sp), prec)
        by_arm.setdefault(key, {})["b128" if fixed else "plan"] = r

    out = []
    print(f"{'mask':16s} {'sp':>5s} {'prec':>8s} {'plan':>12s} "
          f"{'GF_plan':>8s} {'GF_128':>7s} {'meas_x':>7s} {'est_x':>6s}")
    for (mtype, sp, prec), arms in sorted(by_arm.items()):
        if "plan" not in arms:
            continue
        p = arms["plan"]
        gf_p = float(p["gflops"])
        if "b128" in arms:
            gf_1 = float(arms["b128"]["gflops"])
            meas = float(arms["b128"]["time"]) / float(p["time"])
        elif p["fmt"].endswith("128x128"):
            # the plan chose 128x128 itself: speedup is 1 by definition
            gf_1, meas = gf_p, 1.0
        else:
            continue          # fixed arm not measured yet
        o = occ.get((mtype, sp), {})
        est = float(o.get("est_speedup_vs_128", "nan"))
        out.append(dict(mask_type=mtype, sparsity=sp, precision=prec,
                        fmt_plan=p["fmt"], gflops_plan=round(gf_p, 1),
                        gflops_128=round(gf_1, 1),
                        measured_speedup=round(meas, 3),
                        est_speedup_vs_128=est,
                        est_error_pct=round(
                            (meas / est - 1.0) * 100, 1) if est == est
                        else float("nan")))
        print(f"{mtype:16s} {sp:5.2f} {prec:>8s} {p['fmt']:>12s} "
              f"{gf_p:8.0f} {gf_1:7.0f} {meas:7.2f} {est:6.2f}")
    if out:
        path = os.path.join(RES, "sddmm_planner_ab.csv")
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(out[0].keys()))
            w.writeheader()
            w.writerows(out)
        print(f"-> {path}")


if __name__ == "__main__":
    main()
