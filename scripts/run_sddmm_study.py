"""SDDMM sparsity/mask-type study (VERDICT r1 item 3).

Reference masks of interest are 0.95-0.98 sparse
(sddmm_code_bench/sddmm_mask.h:28-34); round 1 only benchmarked the
pipeline at 0.5/0.9/0.95 with band_and_random.  This study runs the
standalone SDDMM at sparsity {0.5, 0.9, 0.95, 0.98} x mask type
{band_and_random, band_and_decay} x matmul precision {highest, high},
plus pipeline rows at the same sparsities.

The `high` precision column tests the 3-pass-bf16 matmul against the f32
oracle gate: on occupied-everywhere masks the SDDMM is MXU-bound on a
dense-shaped Q.K^T, so a passing 3-pass run is a near-2x win.

Output: benchmark_results/h100/sddmm_study.csv (+ pipeline rows
appended to pipeline.csv).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from spgrid.bench.harness import run_sddmm, run_pipeline, BenchConfig  # noqa: E402
from spgrid.bench.schema import CSVWriter  # noqa: E402
from spgrid.gen.artificial import artificial_matrix_generation  # noqa: E402

RES = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100")
OUT = os.path.join(RES, "sddmm_study.csv")
PIPE_OUT = os.path.join(RES, "pipeline.csv")
LENGTH = 4096


def _weight(seed):
    # DLMC-twin-class 0.5-dense weights, like the committed pipeline rows
    return artificial_matrix_generation(512, 512, 256, 32, "normal",
                                        seed=seed, placement="random",
                                        bw=1.0)


def main():
    # inherence analysis first (host-only, fast): does any blocking choice
    # dodge the high-sparsity cost, or is every 128^2 block occupied?
    from spgrid.ops.sddmm_plan import occupancy_report
    import csv
    occ_rows = occupancy_report(LENGTH)
    occ_path = os.path.join(RES, "sddmm_occupancy.csv")
    with open(occ_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(occ_rows[0].keys()))
        w.writeheader()
        w.writerows(occ_rows)
    print(f"occupancy analysis -> {occ_path}", flush=True)

    writer = CSVWriter(OUT)
    done = writer.done_keys()
    for mtype in ("band_and_random", "band_and_decay"):
        for sp in (0.5, 0.9, 0.95, 0.98):
            for prec in ("highest", "high"):
                done_fmt = None
                # two arms per point: the occupancy plan AND fixed
                # 128x128 (VERDICT r3 item 4: the planner rewired
                # run_sddmm's blocking before any measurement validated
                # est_speedup_vs_128 — this A/B is that validation)
                for blocks, suff in ((None, ""), ((128, 128), "_b128")):
                    name = f"mask_{LENGTH}_{mtype}_sp{sp}_{prec}{suff}"
                    if (name, "sddmm_bsr", "512") in done:
                        print("skip", name, flush=True)
                        continue
                    # band_size=None -> the reference band table
                    # (sddmm_mask.h:28-34: 0.95->16, 0.98->8); the old
                    # fixed 64 band swamped the 0.95/0.98 targets and
                    # collapsed both mask types to the same pure band
                    cfg = BenchConfig(num_cols=512, sparsity=sp,
                                      sparse_attention_type=mtype,
                                      band_size=None,
                                      matmul_precision=prec,
                                      min_time_s=0.3)
                    try:
                        row = run_sddmm(LENGTH, config=cfg, blocks=blocks)
                        if blocks == (128, 128) and row.fmt == done_fmt:
                            # plan chose 128x128 itself; no second arm
                            continue
                        if blocks is None:
                            done_fmt = row.fmt
                        row.matrix_name = name
                        writer.write(row)
                        print(f"{name} [{row.fmt}]: {row.gflops:.0f} GFLOPS "
                              f"passed={row.errors_passed}", flush=True)
                    except Exception as e:  # noqa: BLE001
                        print(f"{name} FAILED: {type(e).__name__}: {e}",
                              flush=True)
                        if "RESOURCE_EXHAUSTED" in str(e):
                            sys.exit(2)

    # pipeline rows at the high-sparsity masks + decay type (the committed
    # pipeline.csv only covers band_and_random at 0.5/0.9/0.95)
    pw = CSVWriter(PIPE_OUT)
    pdone = pw.done_keys()
    length = 512
    for mtype in ("band_and_random", "band_and_decay"):
        for sp in (0.9, 0.95, 0.98):
            name = f"pipeline_dlmc{length}_{mtype}_sp{sp}"
            if (name, "pipeline_pallas", "512") in pdone:
                continue
            cfg = BenchConfig(num_cols=512, sparsity=sp,
                              sparse_attention_type=mtype,
                              band_size=None, min_time_s=0.3)
            try:
                row = run_pipeline(_weight(1), _weight(2), _weight(3),
                                   config=cfg)
                row.matrix_name = name
                row.kernel = "pipeline_pallas"
                pw.write(row)
                print(f"{name}: total {row.gflops:.0f} sddmm "
                      f"{row.gflops_sddmm:.0f} passed={row.errors_passed}",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"{name} FAILED: {type(e).__name__}: {e}", flush=True)
                if "RESOURCE_EXHAUSTED" in str(e):
                    sys.exit(2)


if __name__ == "__main__":
    main()
