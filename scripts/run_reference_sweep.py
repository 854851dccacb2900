"""Representative benchmark sweep on the GPU.

Produces the committed artifacts under benchmark_results/h100/ the way
the reference commits benchmark_results/amd-epyc7/: a synthetic-dataset
slice (structure grid), the DLMC-twin SpMM rows, SpMV rows, and the
attention-pipeline rows, plus the standard plots.
"""

import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from spgrid.bench.harness import run_spmm, run_pipeline
from spgrid.bench.schema import CSVWriter
from spgrid.core.config import BenchConfig
from spgrid.gen import artificial_matrix_generation, GenParams

OUT = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100")
FAILED = os.path.join(OUT, "failed_attempts.txt")
MAX_ATTEMPTS = 2


def _attempts():
    counts = {}
    if os.path.exists(FAILED):
        for line in open(FAILED):
            key = line.strip()
            counts[key] = counts.get(key, 0) + 1
    return counts


def _record_fail(key: str, err: Exception):
    with open(FAILED, "a") as f:
        f.write(key + "\n")
    # a failed compile/alloc can poison the process's device memory
    # (observed: every subsequent run hits RESOURCE_EXHAUSTED) — exit and
    # let the retry wrapper restart with resume, the reference's
    # one-process-per-run + retry-on-error discipline (run.sh:357-394)
    if "RESOURCE_EXHAUSTED" in str(err):
        print(f"device poisoned after {key}; exiting for restart",
              flush=True)
        sys.exit(2)


def main():
    os.makedirs(OUT, exist_ok=True)
    attempts = _attempts()

    # --- 1. SpMM structure grid (synthetic medium-dataset slice) ----------
    w = CSVWriter(os.path.join(OUT, "spmm_structure_grid.csv"))
    done = w.done_keys()
    cfg = BenchConfig(num_cols=512, min_time_s=0.3)
    for avg, bw, skew in itertools.product((5, 20, 100), (0.05, 0.3), (0, 1000)):
        rows = int((4 * (1 << 20) - 4) / (12 * avg + 4))
        csr = artificial_matrix_generation(
            rows, rows, avg, round(avg / 3, 4), "normal", 14, "random",
            bw, skew, 0.05, 0.05,
            name=f"synth_4MB_a{avg}_b{bw:g}_s{skew}")
        for kernel in ("gell", "sell", "panel", "ell_xla", "auto"):
            key = f"{csr.name}|{kernel}|512"
            if (csr.name, kernel, "512") in done \
                    or attempts.get(key, 0) >= MAX_ATTEMPTS:
                continue
            try:
                row = run_spmm(csr, kernel=kernel, config=cfg)
                w.write(row)
                print(f"OK {csr.name} {kernel}: {row.gflops:.1f} GFLOPS "
                      f"roof={row.roofline_frac:.3f} pass={row.errors_passed}",
                      flush=True)
            except Exception as e:
                print(f"FAIL {csr.name} {kernel}: {type(e).__name__} {e}",
                      flush=True)
                _record_fail(key, e)

    # --- 2. SpMV rows ------------------------------------------------------
    w2 = CSVWriter(os.path.join(OUT, "spmv.csv"))
    done2 = w2.done_keys()
    cfgv = BenchConfig(num_cols=1, min_time_s=0.3)
    for avg, bw in itertools.product((5, 20), (0.05, 0.3)):
        csr = artificial_matrix_generation(
            100000, 100000, avg, round(avg / 3, 4), "normal", 14, "random",
            bw, 0, 0.05, 0.05, name=f"synth_100k_a{avg}_b{bw:g}")
        for kernel in ("csr_xla_coo", "sell", "merge", "gell", "auto"):
            key = f"{csr.name}|{kernel}|1"
            if (csr.name, kernel, "1") in done2 \
                    or attempts.get(key, 0) >= MAX_ATTEMPTS:
                continue
            try:
                row = run_spmm(csr, kernel=kernel, config=cfgv)
                w2.write(row)
                print(f"OK {csr.name} {kernel}: {row.gflops:.2f} GFLOPS "
                      f"pass={row.errors_passed}", flush=True)
            except Exception as e:
                print(f"FAIL {csr.name} {kernel}: {type(e).__name__} {e}",
                      flush=True)
                _record_fail(key, e)

    # --- 3. DLMC-twin SpMM (the headline config) ---------------------------
    w3 = CSVWriter(os.path.join(OUT, "spmm_dlmc_twin.csv"))
    done3 = w3.done_keys()
    csr = artificial_matrix_generation(512, 512, 256, 32, "normal", 14,
                                       "random", 1.0, 0, 0.05, 0.05,
                                       name="dlmc_twin_512_0.5")
    for kernel in ("dense", "bsr_pallas", "panel", "gemm_bound"):
        key = f"{csr.name}|{kernel}|512"
        if (csr.name, kernel, "512") in done3 \
                or attempts.get(key, 0) >= MAX_ATTEMPTS:
            continue
        try:
            row = run_spmm(csr, kernel=kernel,
                           config=BenchConfig(num_cols=512, min_time_s=0.5))
            w3.write(row)
            print(f"OK dlmc {kernel}: {row.gflops:.0f} GFLOPS", flush=True)
        except Exception as e:
            print(f"FAIL dlmc {kernel}: {type(e).__name__} {e}", flush=True)
            _record_fail(key, e)

    # --- 4. Attention pipeline --------------------------------------------
    w4 = CSVWriter(os.path.join(OUT, "pipeline.csv"))
    done4 = w4.done_keys()

    def weight(s):
        return artificial_matrix_generation(512, 512, 256, 32, "normal", s,
                                            "random", 1.0, 0, 0.05, 0.05,
                                            name=f"dlmc512_{s}")
    for sparsity in (0.5, 0.9, 0.95):
        name = f"pipeline_dlmc512_sp{sparsity:g}"
        key = f"{name}|pipeline_pallas|512"
        if (name, "pipeline_pallas", "512") in done4 \
                or attempts.get(key, 0) >= MAX_ATTEMPTS:
            continue
        cfgp = BenchConfig(num_cols=512, sparsity=sparsity, band_size=16,
                           min_time_s=0.5)
        try:
            row = run_pipeline(weight(1), weight(2), weight(3), config=cfgp)
            row.matrix_name = name
            row.kernel = "pipeline_pallas"
            w4.write(row)
            print(f"OK pipeline sp={sparsity}: {row.gflops:.0f} GFLOPS total",
                  flush=True)
        except Exception as e:
            print(f"FAIL pipeline sp={sparsity}: {type(e).__name__} {e}",
                  flush=True)
            _record_fail(key, e)

    # --- 5. n-scalability on the DLMC twin (ref spmm-scalability-n=8..512) --
    w5 = CSVWriter(os.path.join(OUT, "spmm_n_scalability.csv"))
    done5 = w5.done_keys()
    csr5 = csr  # section 3's DLMC twin (identical parameters)
    for n in (8, 32, 128, 512, 2048):
        for kernel in ("dense", "panel"):
            key = f"{csr5.name}|{kernel}|{n}"
            if (csr5.name, kernel, str(n)) in done5 \
                    or attempts.get(key, 0) >= MAX_ATTEMPTS:
                continue
            try:
                row = run_spmm(csr5, kernel=kernel,
                               config=BenchConfig(num_cols=n, min_time_s=0.4))
                w5.write(row)
                print(f"OK n={n} {kernel}: {row.gflops:.0f} GFLOPS",
                      flush=True)
            except Exception as e:
                print(f"FAIL n={n} {kernel}: {type(e).__name__} {e}",
                      flush=True)
                _record_fail(key, e)

    # --- plots -------------------------------------------------------------
    try:
        from spgrid.viz import load_results, plot_gflops_by_matrix, \
            plot_feature_sweep, plot_roofline
        df = load_results(os.path.join(OUT, "spmm_structure_grid.csv"))
        plot_gflops_by_matrix(df, os.path.join(OUT, "spmm_grid_gflops.png"))
        plot_feature_sweep(df, "avg_nnz_per_row",
                           os.path.join(OUT, "spmm_vs_avg_nnz.png"))
        plot_roofline(df, os.path.join(OUT, "spmm_roofline.png"))
        print("plots written", flush=True)
    except Exception as e:
        print(f"plotting failed: {e}", flush=True)


if __name__ == "__main__":
    sys.exit(main() or 0)
