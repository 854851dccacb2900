"""Medium synthetic-dataset study at scale (VERDICT r1 item 2).

Stratified slice of the committed medium parameter file
(matrix_generation_parameters/synthetic_matrices_medium_dataset.txt,
16,190 lines — the reference's full-factorial medium grid,
benchmark_code/CPU/AMD/run.sh:346-398): rows with m <= 262144 (the
1-CPU host generates larger matrices too slowly for a wide slice; the
spread sample covers the >262k sizes), strided to ~320 matrices.

Every matrix runs `auto` (cost-model dispatch).  Every 4th matrix also
runs the fixed kernel portfolio so dispatch accuracy (% of matrices
where auto lands within 10% of the best fixed kernel) can be computed
from the CSV (analysis: spgrid/viz/dataset.py::dispatch_accuracy).

Output: benchmark_results/h100/medium_study.csv (resumable; exit 2 on
device poisoning for the retry wrapper).
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from spgrid.bench.harness import run_spmm, BenchConfig  # noqa: E402
from spgrid.bench.schema import CSVWriter  # noqa: E402
from spgrid.gen.artificial import artificial_matrix_generation  # noqa: E402
from spgrid.gen.params import read_param_file  # noqa: E402

PARAMS = os.path.join(os.path.dirname(__file__), "..",
                      "matrix_generation_parameters",
                      "synthetic_matrices_medium_dataset.txt")
OUT = os.path.join(os.path.dirname(__file__), "..", "benchmark_results",
                   "h100", "medium_study.csv")

MAX_ROWS = 262144
TARGET = 500            # r3: VERDICT asked >=500 stratified (was 320)
PORTFOLIO = ("gell", "cv_gell", "merge", "sell", "ell_xla", "bsr_pallas",
             "panel", "dense", "rbh")
# r5: every 2nd matrix runs the fixed portfolio (was 4) — the dispatch
# accuracy sample (n of portfolio matrices) is the binding target now
# that the gen cache is fully prewarmed
PORTFOLIO_EVERY = 2


CRASHES = os.path.join(os.path.dirname(OUT), ".medium_crashes")
REX = os.path.join(os.path.dirname(OUT), ".medium_rex")


def param_name(p) -> str:
    """Canonical matrix name for a param line — shared with the cache
    prewarmer (ADVICE r4: one copy, or the prewarm desynchronizes)."""
    return (f"art_{p.nr_rows}_{p.nr_cols}_{p.avg_nnz_per_row:g}_"
            f"{p.std_nnz_per_row:g}_{p.distribution}_{p.placement}_"
            f"{p.bw:g}_{p.skew:g}_{p.avg_num_neighbours:g}_"
            f"{p.cross_row_similarity:g}_{p.seed}")


def selected_params():
    """The study's stratified + seeded-shuffled matrix list (shared with
    the prewarmer).  A PREFIX of the factorial enumeration is biased
    toward the outermost factor; after shuffling, any prefix is a uniform
    sample (resume is by name, so the order is free)."""
    params = [p for p in read_param_file(PARAMS) if p.nr_rows <= MAX_ROWS]
    stride = max(1, len(params) // TARGET)
    params = params[::stride]
    import numpy as _np
    return [params[i] for i in
            _np.random.default_rng(0).permutation(len(params))], stride


def main():
    t0 = time.time()
    max_s = float(os.environ.get("MEDIUM_STUDY_MAX_S", 9000))
    crash_skip = set()
    if os.path.exists(CRASHES):
        with open(CRASHES) as fh:
            crash_skip = {tuple(l.strip().split("|")) for l in fh if "|" in l}
    if os.path.exists(REX):
        # two-strike OOM quarantine (ADVICE r4): a matrix that
        # deterministically RESOURCE_EXHAUSTs would otherwise be retried
        # on every restart, burning the retry wrapper's budget in a loop
        from collections import Counter
        with open(REX) as fh:
            cnt = Counter(tuple(l.strip().split("|")) for l in fh if "|" in l)
        crash_skip |= {key for key, c in cnt.items() if c >= 2}
    params, stride = selected_params()
    print(f"{len(params)} matrices (stride {stride}, shuffled)", flush=True)
    writer = CSVWriter(OUT)
    done = writer.done_keys()
    cfg = BenchConfig(num_cols=512, min_time_s=0.25)
    for i, p in enumerate(params):
        kernels = ["auto"]
        if i % PORTFOLIO_EVERY == 0:
            kernels += list(PORTFOLIO)
        name = param_name(p)
        todo = [kk for kk in kernels if (name, kk, "512") not in done]
        if not todo:
            continue
        if time.time() - t0 > max_s:
            # resumable: leave the rest for the next round/restart
            print(f"wall budget {max_s:.0f}s reached; stopping", flush=True)
            return
        print(f"[{i+1}/{len(params)}] {name} -> {todo}", flush=True)
        try:
            csr = artificial_matrix_generation(
                p.nr_rows, p.nr_cols, p.avg_nnz_per_row, p.std_nnz_per_row,
                p.distribution, seed=p.seed, placement=p.placement,
                bw=p.bw, skew=p.skew,
                avg_num_neighbours=p.avg_num_neighbours,
                cross_row_similarity=p.cross_row_similarity, name=name)
        except Exception as e:  # noqa: BLE001
            print(f"  gen FAILED: {type(e).__name__}: {e}", flush=True)
            continue
        # applicability gate for FIXED portfolio kernels: the cost model
        # returns +inf where a format cannot run this matrix (e.g. dense
        # on m=262k would densify 256GB -> device OOM -> exit-2 restart
        # loop burning the whole retry budget on one row)
        if len(todo) > 1 or todo != ["auto"]:
            from spgrid.bench.harness import KERNELS
            from spgrid.features.structural import matrix_features
            from spgrid.ops.costmodel import estimate_spmm_time
            import math
            f = matrix_features(csr)
            kept = []
            for kk in todo:
                fmt = KERNELS.get(kk)
                if fmt is None or math.isfinite(
                        estimate_spmm_time(f, fmt, 512)):
                    kept.append(kk)
                else:
                    print(f"  skip {kk}: inapplicable (cost model inf)",
                          flush=True)
            todo = kept
        for kk in todo:
            if (name, kk) in crash_skip:
                print(f"  {kk}: skipped (crashed the worker previously)",
                      flush=True)
                continue
            try:
                row = run_spmm(csr, kernel=kk, config=cfg)
                writer.write(row)
                print(f"  {kk}: {row.fmt} {row.gflops:.1f} GF "
                      f"passed={row.errors_passed}", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"  {kk} FAILED: {type(e).__name__}: "
                      f"{str(e)[:160]}", flush=True)
                msg = str(e)
                # a kernel fault poisons the PROCESS (newkernels r4
                # lesson): quarantine the (matrix, kernel) and exit 2 so
                # the retry wrapper restarts us clean
                if "UNAVAILABLE" in msg or "crashed" in msg:
                    with open(CRASHES, "a") as fh:
                        fh.write(f"{name}|{kk}\n")
                    sys.exit(2)
                if "RESOURCE_EXHAUSTED" in msg:
                    # count attempts: a row that OOMs twice is genuinely
                    # too big, not collateral poisoning — quarantine it
                    with open(REX, "a") as fh:
                        fh.write(f"{name}|{kk}\n")
                    sys.exit(2)


if __name__ == "__main__":
    main()
