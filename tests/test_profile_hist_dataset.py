"""Profiling cost model, feature histograms, ML-dataset merge."""

import numpy as np
import jax
import jax.numpy as jnp

from spgrid.core.profile import trace, annotate, spmm_cost, cost_report
from spgrid.features import (
    degree_histogram, bandwidth_histogram, scatter_histogram,
)
from spgrid.formats import random_csr
from spgrid.viz import merge_result_csvs, to_ml_dataset
from spgrid.bench.schema import BenchRow, CSVWriter


def test_spmm_cost_roofline():
    import math
    from spgrid.core.roofline import H100_SXM
    # the cost model's arithmetic against a published peak table (the CPU
    # backend has none: its roofline is NaN)
    assert math.isnan(spmm_cost(nnz=10_000, m=1000, k=1000,
                                n=512).sol_time_s)
    c = spmm_cost(nnz=10_000, m=1000, k=1000, n=512, chip=H100_SXM)
    assert c.flops == 2 * 10_000 * 512
    assert c.hbm_bytes > 10_000 * 8
    assert c.sol_time_s > 0
    # achieved fraction at exactly sol time is 1.0
    assert abs(c.achieved_fraction(c.sol_time_s) - 1.0) < 1e-9
    line = cost_report("csr", c, c.sol_time_s * 2)
    assert "achieved=50.0%" in line


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path / "prof")):
        with annotate("phase1"):
            jax.block_until_ready(jnp.ones((8, 8)) @ jnp.ones((8, 8)))
    # a trace directory with at least one event file must exist
    files = list((tmp_path / "prof").rglob("*"))
    assert files, "no profiler output written"


def test_histograms():
    csr = random_csr(200, 300, 0.05, seed=1)
    for fn in (degree_histogram, bandwidth_histogram):
        counts, edges = fn(csr)
        assert counts.sum() == 200
        assert len(edges) == len(counts) + 1
    counts, edges = scatter_histogram(csr)
    assert counts.sum() <= 200 and edges[0] == 0.0 and edges[-1] == 1.0


def test_merge_result_csvs(tmp_path):
    p1 = tmp_path / "gpu_a.csv"
    w = CSVWriter(str(p1))
    w.write(BenchRow(matrix_name="m1", kernel="bsr_pallas", csr_m=100,
                     csr_k=100, csr_nnz=1000, input_columns=512,
                     csr_mem_footprint_mb=0.01, gflops=100.0,
                     density=0.1, avg_nnz_per_row=10.0, num_devices=1))
    w.write(BenchRow(matrix_name="m2", kernel="bsr_pallas", csr_m=10,
                     csr_k=10, csr_nnz=10, input_columns=512,
                     csr_mem_footprint_mb=0.001, gflops=1.0,
                     errors_passed=0, num_devices=1))
    df = merge_result_csvs([str(p1)])
    assert len(df) == 1  # failed-oracle row dropped
    assert df["source"].iloc[0] == "gpu_a"
    assert "arithmetic_intensity" in df and "gflops_per_device" in df
    X, y = to_ml_dataset(df)
    assert X.shape[0] == 1 and y[0] == 100.0


def test_twin_ape():
    import pandas as pd
    from spgrid.viz import twin_ape

    df = pd.DataFrame({
        "matrix_name": ["scircuit", "scircuit_twin", "mawi", "mawi_twin"],
        "kernel": ["bsr"] * 4,
        "gflops": [100.0, 90.0, 50.0, 60.0],
    })
    out = twin_ape(df)
    assert len(out) == 2
    assert abs(out[out.matrix == "scircuit"].ape.iloc[0] - 10.0) < 1e-9
    assert abs(out.attrs["mape"] - 15.0) < 1e-9
