"""Single benchmark configuration object.

The reference scatters configuration over three tiers: compile-time ``-D``
flags, ``getenv`` at each use site, and a bash associative array echoed into
every log (``benchmark_code/CPU/AMD/config.sh:40-225``,
``spmv_code_bench/spmv_bench.cpp:280-289,588-599``).  Here a single dataclass
carries the whole run configuration and is serialized into every result row
for provenance.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


_ENV_PREFIX = "SPGRID_"

# Environment variable names honored for reference parity
# (spmv_bench.cpp:280-289, sddmm_bench.cpp:1219-1225).
_REFERENCE_ENV_ALIASES = {
    "NUM_COLS": "num_cols",
    "BAND_SIZE": "band_size",
    "SPARSITY": "sparsity",
    "L_SPARSITY": "l_sparsity",
    "SPARSE_ATTENTION_TYPE": "sparse_attention_type",
    "SDDMM_SPARSIFICATION_TYPE": "sddmm_sparsification_type",
    "COOLDOWN": "cooldown",
}


@dataclasses.dataclass
class BenchConfig:
    """Full configuration of a benchmark run.

    Field semantics follow the reference env-var contract (SURVEY.md §1):
      num_cols          — dense-operand width ``n`` for SpMM/SDDMM
                          (NUM_COLS, default 512: AMD/config.sh:54)
      warmup_iters      — kernel warm-up iterations (spmv_bench.cpp:316-320)
      min_time_s        — timed loop runs until this wall time is exceeded
                          (spmv_bench.cpp:367-378 loops until t > 0.3ish)
      min_iters         — and at least this many iterations
      sparsity          — attention-mask *density* of kept entries
                          (sddmm_mask.h:16-80; note inverted naming kept
                          for parity)
      band_size         — half-width of the dense diagonal band
      l_sparsity        — band vs off-band density split (sddmm_mask.h:22-38)
      sparse_attention_type — 'band_and_random' | 'band_and_decay'
      dtype             — 'float32' | 'bfloat16' | 'float64'
      seed              — deterministic RNG seed (README.md:14 of reference:
                          seeded generation for cross-platform reproducibility)
    """

    # Kernel / operand shape
    num_cols: int = 512
    dtype: str = "float32"

    # Timing protocol (BASELINE.md "Measurement protocol")
    warmup_iters: int = 10
    min_time_s: float = 0.5
    min_iters: int = 32
    cooldown: float = 0.0
    # Iterations fused inside one jit call (0 = auto: chained timing for
    # matrices small enough that host dispatch would dominate).
    chained_iters: int = 0

    # Sparse-attention knobs
    sparsity: float = 0.9
    band_size: int = 64
    l_sparsity: float = 0.5
    sparse_attention_type: str = "band_and_random"
    sddmm_sparsification_type: str = "none"

    # Matmul precision: 'auto' = HIGHEST for f32/f64 (true f32, matching the
    # reference's f32 accuracy contract), 'default' for bf16.  The GPU's
    # default f32 matmul runs in TF32 (~3 digits) and would fail the
    # reference gate.
    matmul_precision: str = "auto"

    # Accuracy oracle placement: 'host' = f64 Kahan on host (the
    # definition; core/metrics.py), 'device' = double-float gold +
    # on-device metrics (core/device_oracle.py; ~10-scalar fetch instead
    # of an (m, n) result download and an m x n host f64 pass), 'auto' =
    # device on accelerator backends when the result exceeds ~32MB.  The two agree to the
    # oracle noise floor (~1e-13 relative; pinned by tests).
    oracle: str = "auto"

    # Chained-timing trip count: 'dynamic' = one jit for all loop lengths
    # (sweep default: compiles dominate sweeps on this platform),
    # 'static' = per-length jits with constant bounds (headline rows:
    # the dynamic loop's bookkeeping reads +5-7% on ~10us kernels —
    # measured, timing_protocol_ab.csv).
    timing_protocol: str = "dynamic"

    # Dense-operand source: 'host' = numpy PCG64 + transfer (make_x),
    # 'device' = threefry on device, zero transfer (device_oracle.
    # device_x; bit-reproducible on CPU for the host passes), 'auto' =
    # device whenever the device oracle is in effect.
    x_source: str = "auto"

    # Reproducibility
    seed: int = 14

    # Accuracy gate epsilon per dtype: 1e-7 f32 / 1e-10 f64
    # (spmv_bench.cpp:124-129).  bfloat16 gets a looser gate since the
    # reference never ran bf16; 8-bit mantissa => ~2^-8 relative error and
    # error accumulates over the reduction.
    @property
    def epsilon(self) -> float:
        return {"float32": 1e-7, "float64": 1e-10, "bfloat16": 3e-2}[self.dtype]

    @property
    def precision(self) -> str:
        if self.matmul_precision != "auto":
            return self.matmul_precision
        return "default" if self.dtype == "bfloat16" else "highest"

    @classmethod
    def from_env(cls, **overrides) -> "BenchConfig":
        """Build a config from SPGRID_* (or reference-parity) env vars."""
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for env_name, field_name in _REFERENCE_ENV_ALIASES.items():
            for candidate in (_ENV_PREFIX + env_name, env_name):
                val = os.environ.get(candidate)
                if val is not None:
                    kwargs[field_name] = _coerce(fields[field_name].type, val)
                    break
        for name, f in fields.items():
            val = os.environ.get(_ENV_PREFIX + name.upper())
            if val is not None:
                kwargs[name] = _coerce(f.type, val)
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "BenchConfig":
        return cls(**json.loads(s))


def _coerce(annotation, value: str):
    ann = str(annotation)
    if "int" in ann:
        return int(value)
    if "float" in ann:
        return float(value)
    if "bool" in ann:
        return value.lower() in ("1", "true", "yes")
    return value
