import os
import numpy as np
import pytest

from spgrid.bench import BenchRow, CSVWriter, run_spmm, run_sweep
from spgrid.core.config import BenchConfig
from spgrid.core.metrics import gold_spmm, gold_spmm_fast
from spgrid.formats import random_csr
from spgrid.gen import artificial_matrix_generation


def small_cfg(**kw):
    return BenchConfig(num_cols=32, warmup_iters=1, min_time_s=0.01,
                       min_iters=2, **kw)


def test_gold_fast_matches_kahan():
    csr = random_csr(60, 50, density=0.1, seed=2, dtype=np.float64)
    x = np.random.default_rng(0).random((50, 4))
    np.testing.assert_allclose(
        gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x),
        gold_spmm(csr.row_ptr, csr.col_idx, csr.values, x), rtol=1e-12)


def test_run_spmm_row():
    import math
    csr = artificial_matrix_generation(200, 200, 6, 2, seed=14)
    row = run_spmm(csr, kernel="csr_xla_coo", config=small_cfg())
    assert row.errors_passed == 1
    assert row.gflops > 0
    assert row.csr_nnz == csr.nnz
    # the CPU backend has no published peak: no roofline columns
    assert math.isnan(row.roofline_frac) and math.isnan(row.sol_time)
    assert row.device == "cpu"
    assert row.avg_nnz_per_row == pytest.approx(6, rel=0.2)


@pytest.mark.parametrize("kernel", [
    "csr_xla_coo", "ell_xla", "bsr_xla", "bsr_pallas", "panel", "dense",
    "gemm_bound", "auto", "sell", "merge", "gell", "rbh", "csc", "cv_panel",
])
def test_run_spmm_all_kernels(kernel):
    csr = artificial_matrix_generation(150, 150, 8, 2, seed=14, bw=0.3)
    row = run_spmm(csr, kernel=kernel, config=small_cfg())
    assert row.errors_passed == 1, kernel


def test_csv_roundtrip(tmp_path):
    p = str(tmp_path / "out.csv")
    w = CSVWriter(p)
    w.write(BenchRow(matrix_name="m1", kernel="k1", input_columns=32,
                     time=0.5, gflops=1.0))
    w.write(BenchRow(matrix_name="m2", kernel="k1", input_columns=32))
    done = CSVWriter(p).done_keys()
    assert ("m1", "k1", "32") in done and ("m2", "k1", "32") in done
    with open(p) as f:
        header = f.readline().strip()
    assert header == BenchRow.header()


def test_sweep_resume(tmp_path):
    p = str(tmp_path / "sweep.csv")
    csrs = [artificial_matrix_generation(100, 100, 5, 1, seed=s,
                                         name=f"mat{s}") for s in (1, 2)]
    rows = run_sweep(csrs, kernels=("csr_xla_coo",), num_cols_list=(16,),
                     config=small_cfg(), out_csv=p, echo=False)
    assert len(rows) == 2
    # resume: nothing new
    rows2 = run_sweep(csrs, kernels=("csr_xla_coo",), num_cols_list=(16,),
                      config=small_cfg(), out_csv=p, echo=False)
    assert len(rows2) == 0


def test_cli_labels(capsys):
    from spgrid.bench.cli import main
    assert main(["--labels"]) == 0
    out = capsys.readouterr().out
    assert out.strip() == BenchRow.header()


def test_cli_generate(capsys, tmp_path):
    from spgrid.bench.cli import main
    rc = main(["--generate", "300 300 5 1.6667 normal random 0.05 0 0.05 0.05 14",
               "--kernel", "csr_xla_coo", "--num-cols", "16",
               "--out", str(tmp_path / "r.csv")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "csr_xla_coo" in err


def test_run_sddmm_standalone():
    """Standalone SDDMM bench (sddmm_code_bench analogue): both kernels
    produce a row that passes the float64 oracle."""
    from spgrid.bench.harness import run_sddmm
    from spgrid.core.config import BenchConfig

    cfg = BenchConfig(num_cols=32, min_time_s=0.02, sparsity=0.85, seed=3)
    for layout in ("bsr", "coo"):
        row = run_sddmm(128, config=cfg, layout=layout)
        assert row.errors_passed == 1
        assert row.csr_m == 128 and row.gflops > 0
        assert row.kernel == f"sddmm_{layout}"
    with pytest.raises(ValueError):
        run_sddmm(128, config=cfg, layout="pallas")


def test_fp64_spmv_cli():
    """BASELINE config 1: fp64 CSR SpMV on the CPU backend via the CLI
    (x64 mode is process-global, so drive it in a subprocess)."""
    import subprocess, sys, os
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "spgrid.bench", "--generate",
         "2000 2000 20 5 normal random 0.05 0 0.05 0.05 14",
         "--kernels", "csr_xla_coo", "--dtype", "float64", "--num-cols", "1"],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [l for l in out.stderr.splitlines() if l.startswith("art_")]
    assert rows, out.stderr[-2000:]
    cols = rows[0].split(",")
    header = [l for l in out.stderr.splitlines() if l.startswith("matrix_name")][0].split(",")
    assert cols[header.index("dtype")] == "float64"
    assert cols[header.index("errors_passed")] == "1"


def test_run_spmm_autotune_kernel():
    """'autotune' measures candidates and runs the best."""
    import numpy as np
    from spgrid.bench.harness import run_spmm
    from spgrid.core.config import BenchConfig
    from spgrid.formats import random_csr, CSRMatrix

    csr = random_csr(96, 96, 0.3, seed=2)
    # positive values: signed values + positive x makes near-zero outputs
    # whose relative error vs the f64 gold is unbounded (gate flake)
    csr = CSRMatrix(csr.row_ptr, csr.col_idx, np.abs(csr.values) + 0.1,
                    csr.shape, csr.name)
    cfg = BenchConfig(num_cols=32, min_time_s=0.02)
    row = run_spmm(csr, kernel="autotune", config=cfg)
    assert row.errors_passed == 1
    assert row.fmt in ("dense", "bsr_pallas", "panel", "ell", "coo",
                       "gell", "merge", "sell", "rbh")


def test_autotune_raises_when_nothing_runnable():
    import pytest
    from spgrid.ops.dispatch import autotune_spmm
    from spgrid.formats import random_csr
    import jax.numpy as jnp
    import numpy as np

    csr = random_csr(64, 64, 0.1, seed=1)
    x = jnp.asarray(np.ones((64, 8), np.float32))
    with pytest.raises(RuntimeError):
        autotune_spmm(csr, x, candidates=("nonexistent_fmt",))


def test_cli_param_stride(tmp_path, capsys):
    from spgrid.bench.cli import main
    pf = tmp_path / "p.txt"
    lines = [f"{100+i} {100+i} 5 1.6667 normal random 0.05 0 0.05 0.05 14"
             for i in range(6)]
    pf.write_text("\n".join(lines) + "\n")
    rc = main(["--param-file", str(pf), "--stride", "3", "--limit", "2",
               "--kernel", "csr_xla_coo", "--num-cols", "8",
               "--out", str(tmp_path / "r.csv")])
    assert rc == 0
    rows = (tmp_path / "r.csv").read_text().splitlines()[1:]
    names = [r.split(",")[0] for r in rows]
    assert names == ["art_100_100_5_1.6667_normal_random_0.05_0_0.05_0.05_14",
                     "art_103_103_5_1.6667_normal_random_0.05_0_0.05_0.05_14"]


def test_harness_caches_gold_and_operand():
    """Sweep-cost caches: same matrix + config reuses the device operand
    and the f64 gold across kernel rows; CV-class golds stay distinct."""
    from spgrid.bench import harness

    csr = random_csr(96, 96, 0.05, seed=3)
    cfg = BenchConfig(num_cols=16, min_time_s=0.01, min_iters=2)
    harness._XD_CACHE.clear()
    r1 = run_spmm(csr, kernel="csr_xla_coo", config=cfg)
    assert len(harness._XD_CACHE) == 1
    xd1 = next(iter(harness._XD_CACHE.values()))
    gold_cache = csr._spgrid_gold_cache
    assert len(gold_cache) == 1 and next(iter(gold_cache))[-1] == "exact"
    gold1 = next(iter(gold_cache.values()))
    r2 = run_spmm(csr, kernel="dense", config=cfg)
    # same operand object reused, gold not recomputed (same single entry)
    assert next(iter(harness._XD_CACHE.values())) is xd1
    assert next(iter(gold_cache.values())) is gold1
    assert r1.errors_passed and r2.errors_passed
    # a CV kernel gates against its dequantized gold => second entry
    run_spmm(csr, kernel="cv_bf16", config=cfg)
    assert any(k[-1] == "cv_bf16" for k in gold_cache)


def test_harness_cast_cache_carries_features():
    """astype() must not drop the per-matrix feature caches (bf16 leg
    runs many kernels per matrix)."""
    csr = random_csr(64, 64, 0.05, seed=4)
    cfg = BenchConfig(num_cols=8, dtype="bfloat16", min_time_s=0.01,
                      min_iters=2)
    run_spmm(csr, kernel="dense", config=cfg)
    dtype, cast = csr._spgrid_cast_cache
    assert dtype == "bfloat16" and hasattr(cast, "_spgrid_feats")
    run_spmm(csr, kernel="csr_xla_coo", config=cfg)
    assert csr._spgrid_cast_cache[1] is cast


def test_static_timing_protocol():
    """static_lengths timing path: same row shape, sane per-iter time."""
    csr = random_csr(64, 64, 0.05, seed=9)
    cfg = BenchConfig(num_cols=8, min_time_s=0.02, timing_protocol="static")
    row = run_spmm(csr, kernel="csr_xla_coo", config=cfg)
    assert row.errors_passed == 1 and row.time > 0


def test_auto_tol_dispatch_offers_cv_kernels():
    """Tolerance-enabled dispatch is a real path — at tolerance >=
    CV_TOLERANCE the value-compressed kernels join the candidate set
    (explicit opt-in; the headline `auto` stays f32-exact), and the
    giant-m windowed regime where cv_gell's model fails is gated out."""
    import dataclasses
    from spgrid.features.structural import matrix_features
    from spgrid.ops.costmodel import (
        CV_TOLERANCE, tolerant_candidates, select_format_cost)
    from spgrid.gen import artificial_matrix_generation
    csr = artificial_matrix_generation(4096, 4096, 8, 2.5, "normal",
                                       seed=14, placement="random", bw=0.3)
    f = matrix_features(csr)
    assert "cv_gell" in tolerant_candidates(f, 512)
    # the gated regime: giant m, windowable bf16 band
    fg = dataclasses.replace(f, m=250000, n=250000, avg_bw=2000.0,
                             std_bw=500.0)
    assert "cv_gell" not in tolerant_candidates(fg, 512)
    # select_format_cost with tolerance never errors and returns a format
    pick = select_format_cost(f, 512, tolerance=CV_TOLERANCE)
    assert isinstance(pick, str)


def test_auto_tol_runs_through_harness():
    from spgrid.bench.harness import run_spmm, BenchConfig
    from spgrid.gen import artificial_matrix_generation
    csr = artificial_matrix_generation(512, 512, 8, 2.5, "normal", seed=14,
                                       placement="random", bw=0.3)
    row = run_spmm(csr, kernel="auto_tol",
                   config=BenchConfig(num_cols=16, min_time_s=0.02))
    assert row.kernel == "auto_tol"
    assert row.errors_passed == 1
