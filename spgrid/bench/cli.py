"""Benchmark CLI: ``python -m spgrid.bench ...``.

The single-config entry point the reference reaches via
``run.sh → ./spmm_*.exe <matrix>`` with env-var config; here one CLI with
explicit flags (the BenchConfig still honors the reference env vars).

Examples:
  # SURVEY §7 minimum end-to-end slice — artificial matrix, Pallas kernel
  # (compiled for the GPU; on the CPU use an XLA kernel such as csr_xla_coo):
  python -m spgrid.bench --generate "65535 65535 5 1.6667 normal random \
      0.05 0 0.05 0.05 14" --kernel bsr_pallas --num-cols 512

  # parameter-file sweep with resume:
  python -m spgrid.bench --param-file params.txt --kernels bsr_pallas,dense \
      --num-cols 128,512 --out results.csv

  # labels only (reference argc==1 protocol):
  python -m spgrid.bench --labels

  # attention pipeline on DLMC-style weights:
  python -m spgrid.bench --pipeline wk.smtx wq.smtx wv.smtx --sparsity 0.9
"""

from __future__ import annotations

import argparse
import sys

from spgrid.core.config import BenchConfig
from spgrid.bench.schema import BenchRow, CSVWriter
from spgrid.bench.sweep import run_sweep, iter_matrices
from spgrid.gen.params import GenParams, read_param_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spgrid.bench",
                                 description="sparse-kernel benchmark")
    ap.add_argument("--labels", action="store_true",
                    help="print the CSV header row and exit (argc==1 parity)")
    ap.add_argument("--generate", metavar="PARAMS",
                    help="11-field artificial-matrix parameter line")
    ap.add_argument("--param-file", help="file of 11-field parameter lines")
    ap.add_argument("--limit", type=int, default=0,
                    help="use only the first N param-file lines")
    ap.add_argument("--skip", type=int, default=0,
                    help="skip the first N param-file lines")
    ap.add_argument("--stride", type=int, default=1,
                    help="take every Nth param-file line (spread sampling "
                         "of the big factorial grids)")
    ap.add_argument("--matrix", nargs="*", default=[],
                    help=".mtx/.smtx file path(s)")
    ap.add_argument("--pipeline", nargs=3, metavar=("WK", "WQ", "WV"),
                    help="run the sparse-attention pipeline on 3 weight files")
    ap.add_argument("--sddmm", type=int, metavar="LENGTH", default=None,
                    help="standalone SDDMM bench on a LENGTH^2 attention "
                         "mask (sddmm_code_bench analogue)")
    ap.add_argument("--xla-only", action="store_true",
                    help="pipeline: XLA SpMM instead of the Pallas kernel; "
                         "sddmm: the COO form instead of BSR blocks")
    ap.add_argument("--kernel", default="bsr_pallas")
    ap.add_argument("--kernels", help="comma list (overrides --kernel)")
    ap.add_argument("--num-cols", default=None,
                    help="dense width(s), comma list (default from env/512)")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16", "float64"])
    ap.add_argument("--out", help="CSV output path (append + resume)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the accuracy oracle")
    ap.add_argument("--sparsity", type=float, default=None)
    ap.add_argument("--band-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--reorder", default=None,
                    choices=["rcm", "shuffle", "degsort"],
                    help="apply a row/col reordering pass before the "
                         "kernel (reordering-effect study, ref "
                         "epyc5_shuffling / mat_reorder)")
    args = ap.parse_args(argv)

    if args.labels:
        print(BenchRow.header())
        return 0

    from spgrid.core import platform
    platform.setup_compile_cache()

    overrides = {}
    if args.dtype:
        overrides["dtype"] = args.dtype
        if args.dtype == "float64":
            # fp64 path (BASELINE config 1, CPU backend): must be set before
            # the first jax array is created.
            import jax
            jax.config.update("jax_enable_x64", True)
    if args.sparsity is not None:
        overrides["sparsity"] = args.sparsity
    if args.band_size is not None:
        overrides["band_size"] = args.band_size
    if args.seed is not None:
        overrides["seed"] = args.seed
    config = BenchConfig.from_env(**overrides)
    num_cols = ([int(v) for v in args.num_cols.split(",")]
                if args.num_cols else [config.num_cols])

    if args.sddmm:
        from spgrid.bench.harness import run_sddmm
        writer = CSVWriter(args.out, stream=sys.stderr)
        for n in num_cols:
            cfg = BenchConfig(**{**config.__dict__, "num_cols": n})
            row = run_sddmm(args.sddmm, config=cfg,
                            layout="coo" if args.xla_only else "bsr",
                            check_accuracy=not args.no_check)
            writer.write(row)
        return 0

    if args.pipeline:
        from spgrid.io import read_matrix
        from spgrid.bench.harness import run_pipeline
        wk, wq, wv = (read_matrix(p, dtype=config.dtype) for p in args.pipeline)
        writer = CSVWriter(args.out, stream=sys.stderr)
        for n in num_cols:
            cfg = BenchConfig(**{**config.__dict__, "num_cols": n})
            row = run_pipeline(wk, wq, wv, config=cfg,
                               use_pallas=not args.xla_only,
                               check_accuracy=not args.no_check)
            writer.write(row)
        return 0

    kernels = (args.kernels.split(",") if args.kernels else [args.kernel])
    params = []
    if args.generate:
        params.append(GenParams.from_line(args.generate))
    if args.param_file:
        lines = read_param_file(args.param_file)
        lines = lines[args.skip::max(args.stride, 1)]
        params.extend(lines[: args.limit] if args.limit else lines)
    if not params and not args.matrix:
        ap.error("need --generate, --param-file, --matrix, or --pipeline")

    matrices = iter_matrices(params=params, paths=args.matrix,
                             dtype=config.dtype)
    if args.reorder:
        from spgrid.formats.reorder import (
            permute, rcm_order, shuffle_order, degree_sort_order,
        )

        def _reordered(mats):
            for csr in mats:
                if args.reorder == "rcm":
                    order = rcm_order(csr)
                elif args.reorder == "shuffle":
                    order = shuffle_order(csr, seed=config.seed)
                else:
                    order = degree_sort_order(csr)
                out = permute(csr, order)
                out.name = f"{csr.name}_{args.reorder}"
                yield out

        matrices = _reordered(matrices)
    run_sweep(matrices, kernels=kernels, num_cols_list=num_cols,
              config=config, out_csv=args.out,
              check_accuracy=not args.no_check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
