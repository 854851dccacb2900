"""Smoke test of spgrid on one NVIDIA GPU: the main path, end to end.

    python chip_smoke.py              # phases 1-7 on one card
    python chip_smoke.py --calibrate  # device ceilings + cost-model probes
    python chip_smoke.py --multi      # the four-card phase only (4 GPUs)
    python chip_smoke.py --rehearse   # phases 1-7 at tiny sizes on the CPU,
                                      # Pallas kernels in interpret mode

Phases (one line each, with its wall time; any failure raises and the
script exits nonzero):

1. device: kind, count, nvidia-smi name and power limit, compile-cache
   directory, and two practical ceilings (a bf16 matmul, a 1 GiB copy).
2. headline SpMM: ``run_spmm`` on the bench.py DLMC twin (512^2, density
   0.5, n = 512, f32) for dense, the XLA and Pallas BSR kernels, panel and
   auto; every row must pass its oracle.
3. realistic SpMM: ``run_spmm(kernel="auto")`` on a medium-dataset line of
   ~44M nnz (X and Y ~4.5 GB each), gated by the device oracle.
4. oracle agreement: device (double-float) and host (f64) oracles on the
   same kernel output.
5. SDDMM: ``run_sddmm`` on a 4096-long 0.95 mask, BSR and COO layouts.
6. pipeline: ``run_pipeline`` on the three DLMC twins of
   ``__graft_entry__`` with a band_and_random 0.9 mask, Pallas and XLA,
   then ``entry()`` jitted and run once.
7. kernel A/B: the Triton block SpMM against its XLA form and dense.

The last line of standard output is the result,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
it is printed only when every phase passed on a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

DLMC = dict(m=512, density=0.5, n=512)
MEDIUM_LINE = "2200290 2200290 20 6.6667 normal random 0.05 0 0.05 0.05 14"
ORACLE_LINE = "33825 33825 10 3.3333 normal random 0.05 100 1.9 0.05 14"
BAND_LINE = "16384 16384 64 8 normal random 0.02 0 0.05 0.05 14"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase; ``REAL`` on the card, ``TINY`` for the
    CPU rehearsal (same code, same shapes' structure, smaller scale)."""
    matmul_n: int
    copy_bytes: int
    dlmc_m: int
    n: int
    medium_line: str
    oracle_line: str
    band_line: str
    sddmm_len: int
    min_time_s: float


REAL = Sizes(matmul_n=8192, copy_bytes=1 << 30, dlmc_m=DLMC["m"],
             n=DLMC["n"], medium_line=MEDIUM_LINE, oracle_line=ORACLE_LINE,
             band_line=BAND_LINE, sddmm_len=4096, min_time_s=0.3)
TINY = Sizes(matmul_n=256, copy_bytes=1 << 20, dlmc_m=128, n=32,
             medium_line="2000 2000 20 6.6667 normal random 0.05 0 0.05 "
                         "0.05 14",
             oracle_line="3000 3000 10 3.3333 normal random 0.05 100 1.9 "
                         "0.05 14",
             band_line="1024 1024 32 4 normal random 0.02 0 0.05 0.05 14",
             sddmm_len=256, min_time_s=0.01)

F32_GATE = 1e-4          # run_spmm / run_sddmm f32 (bench/harness.py)
PIPELINE_GATE = 1e-3     # run_pipeline f32 (bench/harness.py)


def say(phase: str, msg: str, t0: float) -> None:
    print(f"[{phase}] {msg} (wall {time.perf_counter() - t0:.2f}s)",
          flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def _gen(line: str, name: str):
    from spgrid.gen import artificial_matrix_generation
    from spgrid.gen.params import GenParams
    return artificial_matrix_generation(**GenParams.from_line(line).kwargs(),
                                        name=name)


def _dlmc_twin(m: int, seed: int = 14):
    from spgrid.gen import artificial_matrix_generation
    d = DLMC["density"]
    return artificial_matrix_generation(
        m, m, d * m, d * m / 8, "normal", seed=seed, placement="random",
        bw=1.0, name=f"dlmc_twin_{m}_{seed}")


def _per_call_s(fn, min_time_s: float) -> float:
    from spgrid.core.timing import time_kernel
    return time_kernel(fn, warmup_iters=2, min_time_s=min_time_s,
                       min_iters=4).time_per_iter_s


def _chained_s(fn, x, ops, min_time_s: float, static: bool = False) -> float:
    """Per-iteration time of the harness's chained loop.  static=True
    unrolls the loop by 4, so the loop's own per-iteration cost (~19 us
    on the H100 for a dynamic trip count, the `dispatch` probe) is paid
    once per four kernel calls."""
    from spgrid.core.timing import time_kernel_chained
    return time_kernel_chained(fn, x, operands=ops, min_time_s=min_time_s,
                               static_lengths=static).time_per_iter_s


def ceilings(sz: Sizes) -> dict:
    """A large bf16 matmul and a large copy: what the card reaches on
    plain XLA work, the yardstick for every kernel's share."""
    import jax
    import jax.numpy as jnp
    a = jnp.ones((sz.matmul_n, sz.matmul_n), jnp.bfloat16)
    mm = jax.jit(lambda u: jnp.dot(u, u, preferred_element_type=jnp.float32))
    t_mm = _per_call_s(lambda: mm(a), sz.min_time_s)
    x = jnp.ones((sz.copy_bytes // 4,), jnp.float32)
    cp = jax.jit(lambda u: u + 1.0)
    t_cp = _per_call_s(lambda: cp(x), sz.min_time_s)
    return {"bf16_matmul_tflops": 2.0 * sz.matmul_n ** 3 / t_mm / 1e12,
            "copy_gbytes_per_s": 2.0 * sz.copy_bytes / t_cp / 1e9}


def phase_device(sz: Sizes) -> dict:
    t0 = time.perf_counter()
    from spgrid.core import platform
    ident = platform.device_identity()
    cache = platform.setup_compile_cache()
    print(f"nvidia-smi: {ident.smi}", flush=True)
    c = ceilings(sz)
    say("1 device", f"kind={ident.kind!r} count={ident.count} "
        f"platform={ident.platform} compile_cache={cache} "
        f"bf16 {sz.matmul_n}^3 matmul={c['bf16_matmul_tflops']:.1f} TFLOP/s "
        f"copy {sz.copy_bytes >> 20} MiB={c['copy_gbytes_per_s']:.1f} GB/s",
        t0)
    return {"identity": ident, **c}


def _row_line(row) -> str:
    return (f"{row.kernel}: fmt={row.fmt} time={row.time * 1e6:.2f}us "
            f"gflops={row.gflops:.2f} max_rel_diff={row.max_rel_diff:.3e}")


def phase_headline(sz: Sizes) -> dict:
    from spgrid.bench.harness import run_spmm
    from spgrid.core.config import BenchConfig
    csr = _dlmc_twin(sz.dlmc_m)
    cfg = BenchConfig(num_cols=sz.n, dtype="float32",
                      min_time_s=sz.min_time_s, timing_protocol="static")
    rows = {}
    for kernel in ("dense", "bsr_xla", "bsr_pallas", "panel", "auto"):
        t0 = time.perf_counter()
        row = run_spmm(csr, kernel=kernel, config=cfg)
        _require(row.errors_passed == 1,
                 f"headline {kernel}: max_rel_diff {row.max_rel_diff:.3e} "
                 f"over gate {F32_GATE:g}")
        say("2 headline", f"{_row_line(row)} gate={F32_GATE:g} ok", t0)
        rows[kernel] = row
    return rows


def phase_realistic(sz: Sizes) -> dict:
    from spgrid.bench.harness import run_spmm, _cached_features
    from spgrid.core.config import BenchConfig
    t0 = time.perf_counter()
    csr = _gen(sz.medium_line, "medium_" + sz.medium_line.split()[0])
    t_gen = time.perf_counter() - t0
    _cached_features(csr)
    t_feat = time.perf_counter() - t0 - t_gen
    cfg = BenchConfig(num_cols=sz.n, dtype="float32",
                      min_time_s=sz.min_time_s)
    row = run_spmm(csr, kernel="auto", config=cfg)
    _require(row.errors_passed == 1,
             f"realistic auto ({row.fmt}): max_rel_diff "
             f"{row.max_rel_diff:.3e} over gate {F32_GATE:g}")
    say("3 realistic", f"m={csr.m} nnz={csr.nnz} n={sz.n} "
        f"generate={t_gen:.1f}s features={t_feat:.1f}s {_row_line(row)} "
        f"gate={F32_GATE:g} ok", t0)
    return {"row": row}


def phase_oracle(sz: Sizes) -> dict:
    """Device and host oracles on one kernel output must agree: the
    double-float gold to f64 within 1e-12 relative, and the gated
    max_rel_diff to the bound the CPU tests pin."""
    import jax.numpy as jnp
    from spgrid.bench.harness import make_x
    from spgrid.core.device_oracle import DeviceOracle
    from spgrid.core.metrics import error_metrics, gold_spmm_fast
    from spgrid.ops import dispatch
    t0 = time.perf_counter()
    csr = _gen(sz.oracle_line, "oracle")
    x = make_x(csr.k, sz.n, "float32", 14)
    xd = jnp.asarray(x)
    a = dispatch.build(csr, "coo")
    y = dispatch.spmm_fn("coo")(a, xd)
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    host = error_metrics(gold, np.asarray(y), epsilon=F32_GATE)
    orc = DeviceOracle.from_csr(csr)
    xh = x if len(orc.heavy_rows) else None
    dev = orc.check(y, xd, F32_GATE, x_host=xh)
    orc._ensure_gold(xd)
    hi, lo = orc._gold
    dd = (np.asarray(hi, np.float64) + np.asarray(lo, np.float64))[:csr.m]
    light = np.ones(csr.m, bool)
    light[orc.heavy_rows] = False
    big = (np.abs(gold) > 1e-2) & light[:, None]
    dd_rel = float((np.abs(dd - gold)[big] / np.abs(gold[big])).max())
    diff = abs(dev.max_rel_diff - host.max_rel_diff)
    _require(dd_rel < 1e-12, f"oracle: dd gold vs f64 rel {dd_rel:.3e}")
    _require(diff <= 1e-3 * max(host.max_rel_diff, 1e-12) + 1e-12,
             f"oracle: max_rel_diff device {dev.max_rel_diff:.6e} "
             f"host {host.max_rel_diff:.6e}")
    _require(dev.passed == host.passed, "oracle: gate verdicts differ")
    say("4 oracle", f"m={csr.m} nnz={csr.nnz} n={sz.n} "
        f"result={csr.m * sz.n * 4 / 2**20:.0f}MiB "
        f"max_rel_diff device={dev.max_rel_diff:.6e} "
        f"host={host.max_rel_diff:.6e} |diff|={diff:.3e} "
        f"dd-vs-f64 rel={dd_rel:.3e} heavy_rows={len(orc.heavy_rows)} ok",
        t0)
    return {"device": dev, "host": host, "dd_rel": dd_rel}


def phase_sddmm(sz: Sizes) -> dict:
    from spgrid.bench.harness import run_sddmm
    from spgrid.core.config import BenchConfig
    cfg = BenchConfig(num_cols=sz.n, dtype="float32", sparsity=0.95,
                      min_time_s=sz.min_time_s)
    rows = {}
    for layout in ("bsr", "coo"):
        t0 = time.perf_counter()
        row = run_sddmm(sz.sddmm_len, config=cfg, layout=layout)
        _require(row.errors_passed == 1,
                 f"sddmm {row.kernel}: max_rel_diff {row.max_rel_diff:.3e}")
        say("5 sddmm", f"length={sz.sddmm_len} nnz={row.csr_nnz} "
            f"{_row_line(row)} gate={F32_GATE:g} ok", t0)
        rows[row.kernel] = row
    return rows


def phase_pipeline(sz: Sizes) -> dict:
    import jax
    import __graft_entry__ as graft
    from spgrid.bench.harness import run_pipeline
    from spgrid.core.config import BenchConfig
    wk, wq, wv, mask = graft._flagship_csrs(m=sz.dlmc_m, k=sz.dlmc_m)
    cfg = BenchConfig(num_cols=sz.n, dtype="float32",
                      min_time_s=sz.min_time_s)
    rows = {}
    for use_pallas in (True, False):
        t0 = time.perf_counter()
        row = run_pipeline(wk, wq, wv, mask=mask, config=cfg,
                           use_pallas=use_pallas)
        _require(row.errors_passed == 1,
                 f"pipeline {row.kernel}: max_rel_diff "
                 f"{row.max_rel_diff:.3e} over gate {PIPELINE_GATE:g}")
        say("6 pipeline", f"{_row_line(row)} stage gflops K/Q/V/S/Y="
            f"{row.gflops_spmm_K:.1f}/{row.gflops_spmm_Q:.1f}/"
            f"{row.gflops_spmm_V:.1f}/{row.gflops_sddmm:.1f}/"
            f"{row.gflops_final_spmm:.1f} gate={PIPELINE_GATE:g} ok", t0)
        rows[row.kernel] = row
    if sz is REAL:
        t0 = time.perf_counter()
        fn, args = graft.entry()
        y = jax.block_until_ready(jax.jit(fn)(*args))
        _require(y.shape == (DLMC["m"], 512) and bool(np.isfinite(
            np.asarray(y)).all()), f"entry(): bad output {y.shape}")
        say("6 pipeline", f"entry() jitted: y={y.shape} finite ok", t0)
    return rows


def _time_triplet(name, pallas_fn, xla_fn, dense_fn, x, ops, dense_ops,
                  sz: Sizes) -> dict:
    t0 = time.perf_counter()
    ref = np.asarray(xla_fn(ops, x), np.float64)
    got = np.asarray(pallas_fn(ops, x), np.float64)
    rel = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
    _require(rel < F32_GATE, f"A/B {name}: Triton vs XLA rel {rel:.3e}")
    t = {"triton": _chained_s(pallas_fn, x, ops, sz.min_time_s, True),
         "xla": _chained_s(xla_fn, x, ops, sz.min_time_s, True),
         "dense": _chained_s(dense_fn, x, dense_ops, sz.min_time_s, True)}
    say("7 kernel A/B", f"{name}: triton={t['triton'] * 1e6:.2f}us "
        f"xla={t['xla'] * 1e6:.2f}us dense={t['dense'] * 1e6:.2f}us "
        f"triton/xla={t['triton'] / t['xla']:.3f} rel_vs_xla={rel:.2e}", t0)
    return t


def phase_kernel_ab(sz: Sizes) -> dict:
    """bsr_spmm (Triton) against the XLA form on the same DeviceBSR, and
    against dense, at the headline, pipeline and banded shapes."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as graft
    from spgrid.bench.harness import make_x
    from spgrid.ops import xla as xops
    from spgrid.ops.attention import _with_blocks
    from spgrid.ops.layouts import DeviceBSR
    from spgrid.ops.pallas.bsr_spmm import bsr_spmm

    out = {}
    with jax.default_matmul_precision("highest"):
        def spmm_ab(name, csr):
            x = jnp.asarray(make_x(csr.k, sz.n, "float32", 14))
            a = DeviceBSR.from_csr(csr, bm=128, bk=128)
            dense = jnp.asarray(csr.to_dense())
            out[name] = _time_triplet(
                name, bsr_spmm, xops.spmm_bsr, xops.spmm_dense, x, a, dense,
                sz)
            return a, x

        wk, _, _, mask = graft._flagship_csrs(m=sz.dlmc_m, k=sz.dlmc_m)
        a, x = spmm_ab("spmm dlmc512 (headline, pipeline K/Q/V)", wk)
        kq = bsr_spmm(a, x)
        m_bsr = DeviceBSR.from_csr(mask, bm=128, bk=128)
        s_bsr = _with_blocks(m_bsr, xops.sddmm_bsr(m_bsr, kq, kq))
        s_csr = mask.astype(np.float32)
        out["spmm pipeline Y"] = _time_triplet(
            "spmm mask512 (pipeline Y)", bsr_spmm, xops.spmm_bsr,
            xops.spmm_dense, kq, s_bsr,
            jnp.asarray(np.asarray(s_csr.to_dense())), sz)
        spmm_ab(f"spmm band{sz.band_line.split()[0]}",
                _gen(sz.band_line, "band"))
    return out


def calibrate(sz: Sizes) -> dict:
    """The cost model's machine constants (spgrid/ops/costmodel.py
    ChipConstants), each from one probe on this card."""
    import jax
    import jax.numpy as jnp
    t0 = time.perf_counter()
    c = ceilings(sz)
    n = 512
    rng = np.random.default_rng(0)
    consts = {"eff_bw": c["copy_gbytes_per_s"] * 1e9,
              "matmul_bf16": c["bf16_matmul_tflops"] * 1e12}
    f = jnp.ones((sz.matmul_n, sz.matmul_n), jnp.float32)
    with jax.default_matmul_precision("highest"):
        mm = jax.jit(lambda u: u @ u)
        consts["matmul_f32"] = (2.0 * sz.matmul_n ** 3
                                / _per_call_s(lambda: mm(f), sz.min_time_s))
    take = jax.jit(lambda src, idx: jnp.take(src, idx, axis=0))
    n_idx = max(sz.copy_bytes // (n * 4 * 4), 1024)
    for key, src_rows in (("gather_fast", (16 << 20) // (n * 4)),
                          ("gather_slow", sz.copy_bytes // (n * 4))):
        src = jnp.ones((src_rows, n), jnp.float32)
        idx = jnp.asarray(rng.integers(0, src_rows, n_idx).astype(np.int32))
        consts[key] = n_idx / _per_call_s(lambda: take(src, idx),
                                          sz.min_time_s)
    rows, w = max(sz.copy_bytes // (n * 4 * 8), 1024), 6
    g = jnp.ones((rows, w, n), jnp.float32)
    v = jnp.ones((rows, w), jnp.float32)
    comb = jax.jit(lambda vv, gg: jnp.einsum("rw,rwn->rn", vv, gg))
    consts["combine_bw"] = ((rows * w * n + rows * n) * 4.0
                            / _per_call_s(lambda: comb(v, g), sz.min_time_s))
    nnz = rows * w
    seg = jnp.asarray(np.sort(rng.integers(0, rows, nnz)).astype(np.int32))
    vals = jnp.ones((nnz, n), jnp.float32)
    scat = jax.jit(lambda s, p: jnp.zeros((rows, n), jnp.float32)
                   .at[s].add(p, indices_are_sorted=True))
    consts["scoo_scatter"] = _per_call_s(lambda: scat(seg, vals),
                                         sz.min_time_s) / nnz
    tiny = jnp.ones((8,), jnp.float32)
    consts["dispatch"] = _chained_s(lambda u: u * 1.0, tiny, None,
                                    sz.min_time_s)
    say("8 calibrate", "ChipConstants(" + ", ".join(
        f"{k}={v:.4g}" for k, v in consts.items()) + ")", t0)
    return consts


def phase_multi(n_dev: int = 4, scale: int = 1) -> dict:
    """The dist/ layer on n_dev cards: halo and all-gather row-partitioned
    SpMM over a flat mesh, and the pipeline step over a (data, model)
    mesh, each against the single-card result and the f64 gold."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import __graft_entry__ as graft
    from spgrid.core.metrics import error_metrics, gold_spmm_fast
    from spgrid.dist import (
        DistSparseAttention, available_devices, make_dist_pipeline_step,
        make_dist_spmm, make_mesh, partition_bsr, partition_bsr_halo)
    from spgrid.ops.attention import SparseAttention, attention_pipeline, \
        gold_pipeline
    from spgrid.ops.layouts import DeviceBSR
    from spgrid.ops.pallas.bsr_spmm import bsr_spmm

    devices = available_devices(n_dev)
    out = {}
    t0 = time.perf_counter()
    m = 16384 // scale
    band = _gen(f"{m} {m} 64 8 normal random 0.02 0 0.05 0.05 14", "band")
    n = 512 // scale
    x = (np.random.default_rng(0).random((m, n)) + 0.5).astype(np.float32)
    gold = gold_spmm_fast(band.row_ptr, band.col_idx, band.values, x)
    single = np.asarray(bsr_spmm(DeviceBSR.from_csr(band, 128, 128),
                                 jnp.asarray(x)))
    flat = Mesh(np.asarray(devices), ("model",))
    for part in ("halo", "row_sharded"):
        sh = (partition_bsr_halo if part == "halo" else partition_bsr)(
            band, n_dev, bm=128, bk=128)
        fn = make_dist_spmm(flat, sh, x_partition=part, data_axis=None,
                            use_pallas=True)
        xd = jax.device_put(jnp.asarray(x), NamedSharding(flat, P("model")))
        y = fn(xd)
        devs = {s.device for s in y.addressable_shards}
        _require(len(devs) == n_dev, f"multi {part}: shards on {devs}")
        yh = np.asarray(y)[:m]
        e_gold = error_metrics(gold, yh, epsilon=F32_GATE)
        e_single = float(np.abs(yh - single).max() / np.abs(single).max())
        _require(e_gold.passed, f"multi {part}: vs gold "
                 f"{e_gold.max_rel_diff:.3e}")
        _require(e_single < F32_GATE, f"multi {part}: vs single-card "
                 f"{e_single:.3e}")
        say("multi", f"dist spmm x_partition={part} m={m} n={n} "
            f"devices={len(devs)} max_rel_diff vs gold="
            f"{e_gold.max_rel_diff:.3e} vs single-card={e_single:.3e} ok",
            t0)
        out[part] = e_gold.max_rel_diff
    t0 = time.perf_counter()
    pm = 512 // scale
    wk, wq, wv, mask = graft._flagship_csrs(m=pm, k=pm)
    xp = (np.random.default_rng(1).random((pm, n)) * 0.2).astype(np.float32)
    mesh = make_mesh(("data", "model"), shape=(2, n_dev // 2),
                     devices=devices)
    attn = DistSparseAttention.from_csr(wk, wq, wv, mask,
                                        num_shards=n_dev // 2, bm=128,
                                        bk=128)
    step = make_dist_pipeline_step(mesh, attn, use_pallas=True)
    xd = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(None, "data")))
    with jax.default_matmul_precision("highest"):
        y = step(xd)
        ys, _ = attention_pipeline(SparseAttention.from_csr(wk, wq, wv, mask),
                                   jnp.asarray(xp))
    devs = {s.device for s in y.addressable_shards}
    _require(len(devs) == n_dev, f"multi pipeline: shards on {devs}")
    yp = np.asarray(y)[:pm]
    gold_p = gold_pipeline(wk, wq, wv, mask, xp)
    e_gold = error_metrics(gold_p, yp, epsilon=PIPELINE_GATE)
    ys = np.asarray(ys)
    e_single = float(np.abs(yp - ys).max() / np.abs(ys).max())
    _require(e_gold.passed, f"multi pipeline: vs gold "
             f"{e_gold.max_rel_diff:.3e}")
    _require(e_single < PIPELINE_GATE, f"multi pipeline: vs single-card "
             f"{e_single:.3e}")
    say("multi", f"dist pipeline mesh=(data 2, model {n_dev // 2}) m={pm} "
        f"n={n} devices={len(devs)} max_rel_diff vs gold="
        f"{e_gold.max_rel_diff:.3e} vs single-card={e_single:.3e} ok", t0)
    out["pipeline"] = e_gold.max_rel_diff
    return out


def run(sz: Sizes, which: str) -> None:
    if which == "calibrate":
        phase_device(sz)
        calibrate(sz)
        return
    phase_device(sz)
    phase_headline(sz)
    phase_realistic(sz)
    phase_oracle(sz)
    phase_sddmm(sz)
    phase_pipeline(sz)
    phase_kernel_ab(sz)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--multi", action="store_true",
                      help="run only the four-card phase")
    mode.add_argument("--calibrate", action="store_true",
                      help="measure the cost model's machine constants")
    mode.add_argument("--rehearse", action="store_true",
                      help="tiny sizes on the CPU, Pallas interpreted")
    args = ap.parse_args(argv)

    import jax
    from spgrid.core import platform
    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
        platform.allow_interpret()
        run(TINY, "main")
        print("rehearsal ok (CPU; no device result)", flush=True)
        return 0
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    platform.setup_compile_cache()
    if args.multi:
        print(f"nvidia-smi: {platform.device_identity().smi}", flush=True)
        phase_multi(4)
    else:
        run(REAL, "calibrate" if args.calibrate else "main")
    ident = platform.device_identity()
    print(json.dumps({"ok": True, "device": ident.as_dict()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
