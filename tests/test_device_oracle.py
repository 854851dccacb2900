"""Device-resident oracle vs the host float64 definition (core/metrics.py).

The double-float gold and on-device metric partials must agree with the
host oracle to far better than any gate threshold; these tests pin that
agreement on the CPU backend (the transforms are pure IEEE f32 ops;
chip_smoke.py phase 4 checks the same agreement on the GPU).
"""
import numpy as np
import jax.numpy as jnp

from spgrid.core.device_oracle import (
    DeviceOracle, device_x, host_x_of_device)
from spgrid.core.metrics import error_metrics, gold_spmm_fast
from spgrid.formats import random_csr


def _gold64(csr, x):
    return gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values,
                          np.asarray(x, np.float64))


def test_dd_gold_matches_f64():
    csr = random_csr(300, 250, 0.03, seed=5)
    rng = np.random.default_rng(0)
    x = (rng.random((250, 16)) + 0.5).astype(np.float32)
    orc = DeviceOracle.from_csr(csr)
    orc._ensure_gold(jnp.asarray(x))
    hi, lo = orc._gold
    dd = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    gold = _gold64(csr, x)
    dd = dd[:csr.m]
    err = np.abs(dd - gold)
    # terms are O(1): the dd gold is exact to ~eps_f32^2 in ABSOLUTE
    # terms; at strongly-cancelled elements relative error is condition-
    # amplified for ANY fixed-precision oracle (f64 included), so gate
    # the relative bound only where gold is of term magnitude
    assert err.max() < 1e-12
    big = np.abs(gold) > 1e-2
    assert (err[big] / np.abs(gold[big])).max() < 1e-12


def test_metrics_match_host_oracle():
    csr = random_csr(400, 400, 0.02, seed=6)
    rng = np.random.default_rng(1)
    x = (rng.random((400, 8)) + 0.5).astype(np.float32)
    gold = _gold64(csr, x)
    # a plausible f32 kernel result: gold rounded + small perturbation
    test = gold.astype(np.float32)
    test[7, 3] += 3e-6 * abs(test[7, 3])
    host = error_metrics(gold, test, epsilon=1e-4)
    dev = DeviceOracle.from_csr(csr).check(
        jnp.asarray(test), jnp.asarray(x), 1e-4)
    assert dev.passed == host.passed
    assert abs(dev.max_ae - host.max_ae) <= 1e-6 * max(host.max_ae, 1e-30)
    assert abs(dev.max_rel_diff - host.max_rel_diff) \
        <= 1e-3 * max(host.max_rel_diff, 1e-12) + 1e-12
    for f in ("mae", "mse", "mape", "smape"):
        h, d = getattr(host, f), getattr(dev, f)
        assert abs(d - h) <= 2e-3 * max(abs(h), 1e-30) + 1e-18, (f, h, d)
    assert abs(dev.lnQ_error - host.lnQ_error) < 1e-6


def test_gate_fails_on_corruption():
    csr = random_csr(64, 64, 0.1, seed=7)
    x = np.ones((64, 4), np.float32)
    gold = _gold64(csr, x)
    bad = gold.astype(np.float32)
    bad[3, 2] += 0.5 * max(abs(bad[3, 2]), 1.0)
    dev = DeviceOracle.from_csr(csr).check(
        jnp.asarray(bad), jnp.asarray(x), 1e-4)
    assert not dev.passed


def test_heavy_rows_host_pass():
    # one row far over the slot budget -> host f64 pass must cover it
    m = k = 128
    rows = [np.arange(0, k, 7)] * m
    rows[5] = np.arange(k)              # heavy row: full
    ptr = np.zeros(m + 1, np.int64)
    cols = []
    rng = np.random.default_rng(2)
    for i, r in enumerate(rows):
        cols.append(r)
        ptr[i + 1] = ptr[i] + len(r)
    cols = np.concatenate(cols).astype(np.int32)
    vals = (rng.random(len(cols)) + 0.5).astype(np.float32)
    from spgrid.formats import CSRMatrix
    csr = CSRMatrix(ptr, cols, vals, (m, k))
    x = (rng.random((k, 8)) + 0.5).astype(np.float32)
    orc = DeviceOracle.from_csr(csr, max_slots=16)
    assert 5 in orc.heavy_rows
    gold = _gold64(csr, x)
    test = gold.astype(np.float32)
    host = error_metrics(gold, test, epsilon=1e-4)
    dev = orc.check(jnp.asarray(test), jnp.asarray(x), 1e-4, x_host=x)
    assert dev.passed == host.passed
    assert abs(dev.mae - host.mae) <= 2e-3 * max(host.mae, 1e-30) + 1e-18
    # corrupt the heavy row specifically: host pass must catch it
    bad = test.copy()
    bad[5, 0] += 1.0
    dev_bad = orc.check(jnp.asarray(bad), jnp.asarray(x), 1e-4, x_host=x)
    assert not dev_bad.passed


def test_device_x_reproducible_on_cpu():
    xd = np.asarray(device_x(96, 8, "float32", 14))
    xh = host_x_of_device(96, 8, "float32", 14)
    assert xd.dtype == np.float32
    assert (xd >= 0.5).all() and (xd < 1.5).all()
    np.testing.assert_array_equal(xd, xh)


def test_run_spmm_device_oracle_end_to_end():
    """run_spmm with the device oracle + device X must produce the same
    gate decision and near-identical metrics as the host-f64 path on the
    same operand."""
    from spgrid.bench import run_spmm
    from spgrid.core.config import BenchConfig
    from spgrid.bench import harness

    csr = random_csr(200, 200, 0.04, seed=8)
    kw = dict(num_cols=16, min_time_s=0.01, min_iters=2)
    harness._XD_CACHE.clear()
    r_dev = run_spmm(csr, kernel="csr_xla_coo",
                     config=BenchConfig(oracle="device", x_source="device",
                                        **kw))
    r_host = run_spmm(csr, kernel="csr_xla_coo",
                      config=BenchConfig(oracle="host", x_source="device",
                                         **kw))
    assert r_dev.errors_passed == 1 and r_host.errors_passed == 1
    for f in ("mae", "max_ae", "mape", "smape"):
        h, d = getattr(r_host, f), getattr(r_dev, f)
        assert abs(d - h) <= 5e-3 * max(abs(h), 1e-30) + 1e-15, (f, h, d)
    # CV class gates against its dequantized gold on device too: the two
    # oracles must agree on the decision AND the metrics (this matrix has
    # sign cancellation, so the gate decision itself is kernel-dependent)
    r_cv_h = run_spmm(csr, kernel="cv_bf16",
                      config=BenchConfig(oracle="host", x_source="device",
                                         **kw))
    r_cv = run_spmm(csr, kernel="cv_bf16",
                    config=BenchConfig(oracle="device", x_source="device",
                                       **kw))
    assert r_cv.errors_passed == r_cv_h.errors_passed
    assert abs(r_cv.max_ae - r_cv_h.max_ae) \
        <= 1e-5 * max(r_cv_h.max_ae, 1e-30)
    # and a gell16-class split-X gold: decisions + metrics agree
    r16_h = run_spmm(csr, kernel="gell16",
                     config=BenchConfig(oracle="host", x_source="device",
                                        **kw))
    r16_d = run_spmm(csr, kernel="gell16",
                     config=BenchConfig(oracle="device", x_source="device",
                                        **kw))
    assert r16_d.errors_passed == r16_h.errors_passed
    assert abs(r16_d.max_ae - r16_h.max_ae) \
        <= 1e-5 * max(r16_h.max_ae, 1e-30)
