"""chip_smoke.py's phases at tiny sizes: the CPU rehearsal of what the
script runs on the card (Pallas kernels interpreted)."""

import json
import os
import subprocess
import sys

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase():
    out = cs.phase_device(cs.TINY)
    assert out["identity"].platform == "cpu"
    assert out["bf16_matmul_tflops"] > 0 and out["copy_gbytes_per_s"] > 0


def test_headline_phase():
    rows = cs.phase_headline(cs.TINY)
    assert set(rows) == {"dense", "bsr_xla", "bsr_pallas", "panel", "auto"}
    assert all(r.errors_passed == 1 and r.max_rel_diff < cs.F32_GATE
               for r in rows.values())


def test_realistic_phase():
    row = cs.phase_realistic(cs.TINY)["row"]
    assert row.kernel == "auto" and row.errors_passed == 1


def test_oracle_phase():
    out = cs.phase_oracle(cs.TINY)
    assert out["dd_rel"] < 1e-12
    assert out["device"].passed and out["host"].passed


def test_sddmm_phase():
    rows = cs.phase_sddmm(cs.TINY)
    assert set(rows) == {"sddmm_bsr", "sddmm_coo"}


def test_pipeline_phase():
    rows = cs.phase_pipeline(cs.TINY)
    assert set(rows) == {"pipeline_pallas", "pipeline_xla"}
    assert all(r.max_rel_diff < cs.PIPELINE_GATE for r in rows.values())


def test_kernel_ab_phase():
    out = cs.phase_kernel_ab(cs.TINY)
    assert len(out) == 3
    for t in out.values():
        assert set(t) == {"triton", "xla", "dense"}
        assert all(v > 0 for v in t.values())


def test_calibrate_probes():
    consts = cs.calibrate(cs.TINY)
    assert set(consts) == {"eff_bw", "matmul_bf16", "matmul_f32",
                           "gather_fast", "gather_slow", "combine_bw",
                           "scoo_scatter", "dispatch"}
    assert all(v > 0 for v in consts.values())


def test_multi_phase_on_four_virtual_devices():
    out = cs.phase_multi(4, scale=4)
    assert set(out) == {"halo", "row_sharded", "pipeline"}


def test_script_refuses_cpu_without_result():
    """No accelerator: exit nonzero and print no result line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu_with_one_json_line():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1 and "no GPU" in json.loads(lines[0])["error"]
