"""Driver benchmark: one JSON line on the headline metric.

Headline: SpMM f32, n=512, on the DLMC-twin matrix (512x512 pruned
transformer weight, ~50% sparse) — the reference's best number for this
configuration is MKL CSR SpMM at 251.0 GFLOPS on a 24-thread AMD EPYC
(BASELINE.md, benchmark_results/amd-epyc7/spmm-scalability-n=512/
mkl_csr_f_24.csv:2).  vs_baseline = our GFLOPS / 251.0.

Measures the densified path, the panel layout and the Pallas block kernel
and reports the fastest row that passes the oracle.  It needs the GPU: on
another backend, or when any kernel raises, it prints one JSON line with
an `error` field and exits nonzero.  A hard alarm bounds the whole run.
"""

from __future__ import annotations

import json
import os
import signal
import sys

METRIC = "spmm_dlmc_n512_f32_gflops"
TOTAL_BUDGET_S = 1200


def _fail(reason: str) -> int:
    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "GFLOPS",
                      "vs_baseline": 0.0, "error": reason}), flush=True)
    return 1


def main() -> int:
    def _on_alarm(signum, frame):  # noqa: ARG001
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "GFLOPS",
                          "vs_baseline": 0.0, "error": "timeout"}),
              flush=True)
        os._exit(1)

    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(TOTAL_BUDGET_S)

    import jax
    if jax.default_backend() != "gpu":
        return _fail(f"no GPU (backend {jax.default_backend()!r})")

    from spgrid.core import platform
    from spgrid.core.config import BenchConfig
    from spgrid.bench.harness import run_spmm
    from spgrid.gen import artificial_matrix_generation

    platform.setup_compile_cache()
    csr = artificial_matrix_generation(
        512, 512, 256, 32, "normal", seed=14, placement="random", bw=1.0,
        name="dlmc_twin_512_0.5")
    # static-trip-count protocol: the headline kernel is tens of us/iter,
    # where a dynamic loop's bookkeeping is a visible share
    cfg = BenchConfig(num_cols=512, dtype="float32", min_time_s=1.0,
                      warmup_iters=5, timing_protocol="static")

    best = None
    for kernel in ("dense", "panel", "bsr_pallas"):
        try:
            row = run_spmm(csr, kernel=kernel, config=cfg)
        except Exception as e:  # noqa: BLE001  (reported, then fail)
            print(f"kernel {kernel} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return _fail(f"kernel_failed: {kernel}")
        if row.errors_passed and (best is None or row.gflops > best.gflops):
            best = row

    if best is None:
        return _fail("all_kernels_failed_oracle")

    print(json.dumps({
        "metric": METRIC,
        "value": round(best.gflops, 2),
        "unit": "GFLOPS",
        "vs_baseline": round(best.gflops / 251.0, 3),
        "kernel": best.kernel,
        "device": best.device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
