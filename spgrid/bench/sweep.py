"""Sweep runner: kernels × matrices × configs with resume.

The JAX re-design of the bash orchestration layer (``AMD/run.sh:346-398,
566-685``): iterate the kernel list over a matrix source (parameter file,
directory of .mtx/.smtx, or explicit list) and dense-width list, appending
one CSV row per run.  Failure handling follows the reference's
retry-on-error / skip-completed discipline (run.sh:357-394; SURVEY §5
"failure detection": per-matrix result append + resume)."""

from __future__ import annotations

import sys
import traceback
from typing import Iterable, List, Optional, Sequence

from spgrid.core.config import BenchConfig
from spgrid.formats.csr import CSRMatrix
from spgrid.gen.artificial import artificial_matrix_generation
from spgrid.gen.params import GenParams, read_param_file
from spgrid.bench.harness import run_spmm
from spgrid.bench.schema import BenchRow, CSVWriter


def iter_matrices(
    params: Optional[Sequence[GenParams]] = None,
    csrs: Optional[Sequence[CSRMatrix]] = None,
    paths: Optional[Sequence[str]] = None,
    dtype: str = "float32",
):
    """Yield CSRMatrix from any of the three sources, lazily."""
    import numpy as np
    if params:
        for p in params:
            yield artificial_matrix_generation(**p.kwargs(),
                                               dtype=np.dtype(dtype))
    if csrs:
        yield from csrs
    if paths:
        from spgrid.io import read_matrix
        for path in paths:
            yield read_matrix(path, dtype=dtype)


def run_sweep(
    matrices: Iterable[CSRMatrix],
    kernels: Sequence[str] = ("bsr_pallas",),
    num_cols_list: Sequence[int] = (512,),
    config: Optional[BenchConfig] = None,
    out_csv: Optional[str] = None,
    retries: int = 1,
    echo: bool = True,
    check_accuracy: bool = True,
) -> List[BenchRow]:
    config = config or BenchConfig()
    writer = CSVWriter(out_csv, stream=sys.stderr if echo else None)
    done = writer.done_keys()
    rows: List[BenchRow] = []
    for csr in matrices:
        for kernel in kernels:
            for n in num_cols_list:
                key = (csr.name, kernel, str(n))
                if key in done:
                    print(f"skip (done): {key}", file=sys.stdout)
                    continue
                cfg = BenchConfig(**{**config.__dict__, "num_cols": n})
                row = None
                for attempt in range(retries + 1):
                    try:
                        row = run_spmm(csr, kernel=kernel, config=cfg,
                                       check_accuracy=check_accuracy)
                        break
                    except Exception as e:
                        print(f"error ({csr.name},{kernel},n={n}) "
                              f"attempt {attempt}:", file=sys.stdout)
                        traceback.print_exc(file=sys.stdout)
                        if "RESOURCE_EXHAUSTED" in str(e):
                            # a failed device alloc poisons the process:
                            # every later row would be junk.  Exit with the
                            # retry-wrapper protocol code so the sweep is
                            # restarted fresh with resume (CLAUDE.md trap).
                            print("device poisoned; exiting 2 for restart",
                                  file=sys.stdout, flush=True)
                            raise SystemExit(2)
                if row is None:
                    row = BenchRow(matrix_name=csr.name, kernel=kernel,
                                   input_columns=n, errors_passed=0)
                writer.write(row)
                rows.append(row)
    return rows
