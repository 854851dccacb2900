"""Validation-matrix twin study (the real-matrix leg, VERDICT r1 item 4).

Without network access the real SuiteSparse .mtx files cannot be
fetched (io/datasets.py carries the registry + fetch logic for boxes that
can).  SUBSTITUTION, STATED PLAINLY: each "real" matrix is stood in for by
its feature-exact artificial twin, generated from the MEASURED feature
vectors the reference commits for its validation set
(matrix_generation_parameters/validation_matrices_10_samples_30_range_twins.txt
— the per-matrix base rows; e.g. scircuit's 170998x170998 @ 5.60788
nnz/row reproduces the published nnz 958,936 exactly).  The study then
benchmarks auto-dispatch on every base twin plus +-30% sweeps of the two
most perf-determining features, reproducing the reference's
validation-vs-twin APE methodology
(results_visualization/validation_plotter-SPLITTING.ipynb).

Output: benchmark_results/h100/validation_twins.csv
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from spgrid.bench.harness import run_spmm, BenchConfig  # noqa: E402
from spgrid.bench.schema import CSVWriter  # noqa: E402
from spgrid.gen.artificial import artificial_matrix_generation  # noqa: E402

# TWINS_CALIBRATED=1 (r5, VERDICT r4 item 8): regenerate every twin with
# gen.artificial's nnz calibration (trims the measured +15-18% avg-nnz
# overshoot) into a separate CSV, so the fidelity analysis can compare
# calibrated vs uncalibrated twins row-by-row without touching resume
# keys of the committed uncalibrated leg.
CALIBRATED = os.environ.get("TWINS_CALIBRATED", "") == "1"
OUT = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100",
                   "validation_twins_cal.csv" if CALIBRATED
                   else "validation_twins.csv")

# (name, m, avg_nnz, std_nnz, bw, skew, neigh, crs) — measured features of
# the reference validation set (see module doc for provenance)
BASES = [
    ("scircuit", 170998, 5.60788, 4.39216, 0.29725, 61.94716, 0.80336, 0.63302),
    ("mac_econ_fwd500", 206500, 6.16653, 4.43586, 0.00191, 6.13529, 0.17669, 0.33051),
    ("raefsky3", 21200, 70.22491, 6.327, 0.0662, 0.1392, 1.916, 0.96302),
    ("bbmat", 38744, 45.72894, 38.39531, 0.02989, 1.75537, 1.26263, 0.85373),
    ("conf5_4-8x8-15", 49152, 39.0, 0.0, 0.24469, 0.0, 1.44151, 0.81095),
    ("rma10", 46835, 50.68861, 27.7806, 0.18777, 1.8606, 1.71972, 0.86641),
    ("cop20k_A", 121192, 21.65432, 13.79266, 0.62306, 2.74059, 1.09583, 0.6334),
    ("cant", 62451, 64.16844, 14.05626, 0.0086, 0.21555, 1.61575, 0.91473),
    ("pdb1HYS", 36417, 119.30596, 31.86038, 0.12994, 0.70989, 1.83776, 0.93173),
    ("mc2depi", 525825, 3.99415, 0.07632, 0.00134, 0.00146, 0.4983, 0.99891),
]

SWEEP_FEATURES = ("avg_nnz_per_row", "bw")
SCALES = (0.7, 1.3)


def jobs():
    # ALL base twins first, then per-matrix sweep blocks: if the wall
    # budget cuts the study short, every validation matrix still has its
    # base row, and the first k matrices have complete +-30% sweeps (the
    # twin-APE analysis needs base+swept pairs per matrix)
    sweeps = []
    for (name, m, avg, std, bw, skew, neigh, crs) in BASES:
        base = dict(m=m, avg=avg, std=std, bw=bw, skew=skew, neigh=neigh,
                    crs=crs)
        yield f"{name}_twin", base
        block = []
        for feat in SWEEP_FEATURES:
            for s in SCALES:
                p = dict(base)
                if feat == "avg_nnz_per_row":
                    p["avg"] = round(avg * s, 5)
                else:
                    p["bw"] = round(min(bw * s, 1.0), 5)
                block.append((f"{name}_twin_{feat}_{s}", p))
        sweeps.append(block)
    for block in sweeps:
        yield from block


def main():
    import time
    t0 = time.time()
    max_s = float(os.environ.get("VALIDATION_TWINS_MAX_S", 1e9))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    writer = CSVWriter(OUT)
    done = writer.done_keys()
    cfg = BenchConfig(num_cols=512, min_time_s=0.3)
    for name, p in jobs():
        key = (name, "auto", "512")
        if key in done:
            print(f"skip (done): {name}", flush=True)
            continue
        if time.time() - t0 > max_s:
            print(f"wall budget {max_s:.0f}s reached; stopping", flush=True)
            return
        print(f"=== {name}: m={p['m']} avg={p['avg']} bw={p['bw']}",
              flush=True)
        try:
            csr = artificial_matrix_generation(
                p["m"], p["m"], p["avg"], p["std"], "normal", seed=14,
                placement="random", bw=p["bw"], skew=p["skew"],
                avg_num_neighbours=p["neigh"],
                cross_row_similarity=p["crs"], name=name,
                calibrate_nnz=CALIBRATED)
            row = run_spmm(csr, kernel="auto", config=cfg)
            writer.write(row)
            print(f"  -> {row.fmt} {row.gflops:.1f} GFLOPS "
                  f"passed={row.errors_passed}", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"  FAILED {name}: {type(e).__name__}: {e}", flush=True)
            if "RESOURCE_EXHAUSTED" in str(e):
                sys.exit(2)


if __name__ == "__main__":
    main()
