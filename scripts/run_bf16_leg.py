"""bfloat16 benchmark leg (VERDICT r2 item 6).

The reference ships dual `_d`/`_f` builds of every kernel
(benchmark_code/CPU/AMD/make.sh:98-108) and reports both dtypes; spgrid's
rows were all float32.  This leg measures dtype=bfloat16 — where the
tensor cores' bf16 rate lives — on the headline DLMC-twin matrix
plus one matrix per density regime, gated against the dequantized
(bf16-cast) host gold per the CV-kernel accuracy policy
(bench/harness.py:218-224; epsilon 3e-2 from core/config.py:91).

Output: benchmark_results/h100/bf16_leg.csv (resume; exit 2 on device
poisoning).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from spgrid.bench.harness import run_spmm, BenchConfig  # noqa: E402
from spgrid.bench.schema import CSVWriter  # noqa: E402
from spgrid.gen.artificial import artificial_matrix_generation  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100", "bf16_leg.csv")

JOBS = [
    # headline DLMC twin (50% dense transformer weight)
    ("dlmc_twin_512_0.5", dict(m=512, avg=256, std=32, placement="random",
                               bw=1.0, skew=0, neigh=0, crs=0),
     ["dense", "bsr_pallas", "panel"]),
    # mid-density too big to densify -> panel regime
    ("mid_16k_d2pct", dict(m=16384, avg=328, std=100, placement="random",
                           bw=1.0, skew=0, neigh=1.9, crs=0.25),
     ["panel", "bsr_pallas"]),
    # banded hypersparse -> gell windowed (bf16 X gather + MXU combine)
    ("band_98k", dict(m=98304, avg=8, std=2.6667, placement="random",
                      bw=0.05, skew=0, neigh=0.05, crs=0.5),
     ["gell", "bsr_pallas"]),
    # scattered hypersparse
    ("scat_131k", dict(m=131072, avg=6, std=2, placement="random",
                       bw=0.9, skew=0, neigh=0.9, crs=0.3),
     ["gell", "merge", "sell", "rbh"]),
    # ---- r5 widening (VERDICT r4 item 6: the bf16 axis had essentially
    # no evidence breadth — >=30 rows across >=10 matrices, every kernel
    # family) ----
    ("scat_393k", dict(m=393215, avg=5, std=1.6667, placement="random",
                       bw=0.5, skew=0, neigh=0.5, crs=0.75),
     ["gell", "sell", "rbh"]),
    ("band_229k", dict(m=229375, avg=5, std=1.6667, placement="random",
                       bw=0.05, skew=0, neigh=0.05, crs=0.95),
     ["gell", "sell", "merge"]),
    ("skew1k_131k", dict(m=131072, avg=6, std=2, placement="random",
                         bw=0.9, skew=1000, neigh=0.9, crs=0.3),
     ["merge", "gell"]),
    ("wideband_196k", dict(m=196608, avg=6, std=2, placement="diagonal",
                           bw=0.3, skew=0, neigh=0.3, crs=0.5),
     ["gell", "sell"]),
    ("giant_band_1m", dict(m=1048576, avg=5, std=1.6667,
                           placement="diagonal", bw=0.02, skew=0,
                           neigh=0.02, crs=0.5),
     ["gell"]),
    ("dense_7k_a100", dict(m=7838, avg=100, std=33.3333,
                           placement="random", bw=0.6, skew=100,
                           neigh=0.5, crs=0.5),
     ["dense", "sell", "merge"]),
    ("dense_2k_d20pct", dict(m=2445, avg=500, std=150, placement="random",
                             bw=0.6, skew=3.9, neigh=0.5, crs=0.5),
     ["dense", "bsr_pallas", "panel"]),
    ("scirc_twin", dict(m=170998, avg=5.60788, std=4.39216,
                        placement="random", bw=0.29725, skew=61.94716,
                        neigh=0.80336, crs=0.63302),
     ["gell", "rbh"]),
]


def main():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    writer = CSVWriter(OUT)
    done = writer.done_keys()
    cfg = BenchConfig(num_cols=512, dtype="bfloat16", min_time_s=0.25)
    for tag, p, kernels in JOBS:
        name = f"bf16_{tag}"
        todo = [kk for kk in kernels if (name, kk, "512") not in done]
        if not todo:
            print(f"skip (done): {name}", flush=True)
            continue
        print(f"=== {name} -> {todo}", flush=True)
        try:
            csr = artificial_matrix_generation(
                p["m"], p["m"], p["avg"], p["std"], "normal", seed=14,
                placement=p["placement"], bw=p["bw"], skew=p["skew"],
                avg_num_neighbours=p["neigh"],
                cross_row_similarity=p["crs"], name=name)
        except Exception as e:  # noqa: BLE001
            print(f"  gen FAILED: {type(e).__name__}: {e}", flush=True)
            continue
        for kk in todo:
            try:
                row = run_spmm(csr, kernel=kk, config=cfg)
                writer.write(row)
                print(f"  {kk}: {row.gflops:.1f} GF "
                      f"passed={row.errors_passed}", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"  {kk} FAILED: {type(e).__name__}: {str(e)[:200]}",
                      flush=True)
                if "RESOURCE_EXHAUSTED" in str(e):
                    sys.exit(2)

    # one bf16 attention-pipeline row (the flagship bench on the dtype
    # where the MXU's 198 TFLOPS lives)
    name = "bf16_pipeline_dlmc4096_band_and_random_sp0.95"
    if (name, "pipeline_pallas", "512") not in done:
        from spgrid.bench.harness import run_pipeline
        cfg = BenchConfig(num_cols=512, dtype="bfloat16", sparsity=0.95,
                          sparse_attention_type="band_and_random",
                          band_size=None, min_time_s=0.3)

        def _weight(seed):
            return artificial_matrix_generation(
                512, 512, 256, 32, "normal", seed, "random", 1.0, 0,
                0.05, 0.05, name=f"bf16_w{seed}")

        try:
            row = run_pipeline(_weight(1), _weight(2), _weight(3),
                               config=cfg)
            row.matrix_name = name
            row.kernel = "pipeline_pallas"
            writer.write(row)
            print(f"{name}: total {row.gflops:.0f} "
                  f"passed={row.errors_passed}", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"{name} FAILED: {type(e).__name__}: {e}", flush=True)
            if "RESOURCE_EXHAUSTED" in str(e):
                sys.exit(2)


if __name__ == "__main__":
    main()
