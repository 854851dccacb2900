"""Energy measurement hooks.

The reference measures CPU package energy via Linux powercap RAPL
(``lib/monitoring/power/rapl.{h,c}``: accumulate energy_uj with wraparound,
report J_estimated and W_avg) and GPU energy via NVEM.  On this stack:

- Host-side RAPL is reimplemented below (measures the *host* CPU — relevant
  for generation/packing phases, honest: it is NOT the GPU's power).
- GPU power is not sampled yet (nvidia-smi power.draw is the planned
  source, ROADMAP); the schema keeps ``energy_j``/``w_avg`` columns and fills them when a meter is
  available, mirroring the reference protocol (≥1 s window extension,
  cuSPARSEcsrmv_11_generate.cu:225-236).
"""

from __future__ import annotations

import glob
import os
import time
from typing import List, Optional


class RaplMeter:
    """Powercap RAPL reader (ref rapl.h:24-46 semantics).

    Registers default to every top-level ``intel-rapl:<n>`` package zone, or
    the comma list in $RAPL_REGISTERS (reference env contract,
    config.sh:128-130)."""

    def __init__(self, registers: Optional[List[int]] = None):
        env = os.environ.get("RAPL_REGISTERS")
        if registers is None and env:
            registers = [int(v) for v in env.split(",") if v.strip()]
        if registers is None:
            zones = sorted(glob.glob("/sys/class/powercap/intel-rapl:[0-9]*"))
            self.paths = [z for z in zones if ":" not in os.path.basename(z)[11:]]
            self.paths = zones
        else:
            self.paths = [f"/sys/class/powercap/intel-rapl:{r}"
                          for r in registers]
        self.paths = [p for p in self.paths
                      if os.path.exists(os.path.join(p, "energy_uj"))]
        self._start_uj: List[int] = []
        self._max_uj: List[int] = []
        self._t0 = 0.0
        self.joules = 0.0
        self.watts = 0.0

    @property
    def available(self) -> bool:
        return bool(self.paths)

    def _read(self) -> List[int]:
        out = []
        for p in self.paths:
            try:
                with open(os.path.join(p, "energy_uj")) as f:
                    out.append(int(f.read().strip()))
            except OSError:
                out.append(0)
        return out

    def start(self) -> None:
        self._start_uj = self._read()
        self._max_uj = []
        for p in self.paths:
            try:
                with open(os.path.join(p, "max_energy_range_uj")) as f:
                    self._max_uj.append(int(f.read().strip()))
            except OSError:
                self._max_uj.append(0)
        self._t0 = time.perf_counter()

    def stop(self) -> "RaplMeter":
        """Accumulate uj deltas with counter-wrap handling (rapl.c)."""
        end = self._read()
        dt = time.perf_counter() - self._t0
        total_uj = 0
        for s, e, mx in zip(self._start_uj, end, self._max_uj):
            d = e - s
            if d < 0 and mx > 0:
                d += mx
            total_uj += max(d, 0)
        self.joules = total_uj / 1e6
        self.watts = self.joules / dt if dt > 0 else 0.0
        return self


def measure_energy(fn, min_window_s: float = 1.0):
    """Run ``fn`` repeatedly until the measurement window reaches
    ``min_window_s`` (reference NVEM protocol), metering RAPL if present.

    Returns (iters, seconds, RaplMeter-or-None)."""
    meter = RaplMeter()
    if not meter.available:
        return 0, 0.0, None
    meter.start()
    t0 = time.perf_counter()
    iters = 0
    while True:
        fn()
        iters += 1
        dt = time.perf_counter() - t0
        if dt >= min_window_s:
            break
    meter.stop()
    return iters, dt, meter
