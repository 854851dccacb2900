"""float64 correctness sweep on the CPU backend (VERDICT r1 item 10:
populate the dtype axis — the reference ships _d/_f builds; this leg
runs f64 on the host backend like the reference's CPU builds, gated at
eps=1e-10; f64 on the GPU is a ROADMAP item).

Output: benchmark_results/cpu-f64/f64_correctness.csv
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

from spgrid.bench.harness import run_spmm, BenchConfig  # noqa: E402
from spgrid.bench.schema import CSVWriter  # noqa: E402
from spgrid.gen.artificial import artificial_matrix_generation  # noqa: E402

jax.config.update("jax_enable_x64", True)

OUT = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "cpu-f64", "f64_correctness.csv")

CASES = [
    (4000, 8, 2.0, "normal", 0.1, 0),
    (4000, 40, 30.0, "gamma", 0.8, 1000),
    (8000, 5, 1.7, "normal", 0.05, 0),
]
KERNELS = ("csr_xla_coo", "ell_xla", "csc", "bsr_xla", "dense",
           "merge", "sell")


def main():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    writer = CSVWriter(OUT)
    done = writer.done_keys()
    cfg = BenchConfig(num_cols=64, dtype="float64", min_time_s=0.05)
    for (m, avg, std, dist, bw, skew) in CASES:
        csr = artificial_matrix_generation(m, m, avg, std, dist, seed=14,
                                           placement="random", bw=bw,
                                           skew=skew, dtype="float64")
        for kk in KERNELS:
            if (csr.name, kk, "64") in done:
                continue
            try:
                row = run_spmm(csr, kernel=kk, config=cfg)
                writer.write(row)
                print(f"{csr.name[:30]} {kk}: passed={row.errors_passed} "
                      f"mape={row.mape:.2e}", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"{csr.name[:30]} {kk} FAILED: {e}", flush=True)


if __name__ == "__main__":
    main()
