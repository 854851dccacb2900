"""Tracing / profiling subsystem.

Reference counterpart (SURVEY §5 "Tracing / profiling"): per-phase wall
timers (spmv_bench.cpp:666-768,989-999; time_it.h:46-57), per-thread
compute-vs-barrier breakdown under PRINT_STATISTICS
(spmv_kernel_csr.cpp:359-371), TSC timers, PAPI counters.  The device
equivalents:

- ``trace()``: jax.profiler trace context producing a TensorBoard/xprof
  trace directory (device timeline == the per-thread breakdown analogue).
- ``annotate()``: named trace spans (jax.profiler.TraceAnnotation) so
  harness phases show up on the host timeline.
- ``KernelCost`` + ``cost_report()``: static FLOP/byte cost model per
  kernel invocation, checked against measured time to give the achieved
  roofline fraction (the PAPI-counters analogue — on the device the
  interesting "counters" are bytes streamed and matmul FLOPs, which are
  statically known for these kernels).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import jax

from spgrid.core.roofline import (
    ChipSpec, detect_chip, roofline_time, spmm_flops, csr_bytes,
)


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profile a region into ``logdir`` (view with TensorBoard/xprof).

    Wraps jax.profiler.trace; safe on CPU and GPU backends."""
    with jax.profiler.trace(logdir,
                            create_perfetto_link=create_perfetto_link):
        yield


def annotate(name: str):
    """Named span on the profiler timeline (phase marker)."""
    return jax.profiler.TraceAnnotation(name)


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Static cost estimate for one kernel invocation."""

    flops: float            # useful FLOPs (reference accounting: 2*nnz*n)
    hbm_bytes: float        # minimum streamed bytes for the layout
    sol_time_s: float       # speed-of-light time on the detected chip
    chip: ChipSpec

    def achieved_fraction(self, measured_s: float) -> float:
        """Fraction of speed-of-light achieved (1.0 == at the roofline)."""
        return self.sol_time_s / measured_s if measured_s > 0 else 0.0

    def gflops(self, measured_s: float) -> float:
        return self.flops / measured_s / 1e9 if measured_s > 0 else 0.0


def spmm_cost(nnz: int, m: int, k: int, n: int, *, val_bytes: int = 4,
              idx_bytes: int = 4,
              chip: Optional[ChipSpec] = None) -> KernelCost:
    """Cost estimate for Y[m,n] = A[m,k (nnz)] @ X[k,n].

    Streamed bytes = matrix stream (values+indices) + X read + Y write —
    the csr_mem_footprint accounting of spmv_kernel.h:24 extended with the
    dense traffic."""
    chip = chip or detect_chip()
    flops = spmm_flops(nnz, n)
    bytes_ = csr_bytes(nnz, m, n, k, val_bytes=val_bytes,
                       idx_bytes=idx_bytes)
    return KernelCost(flops=flops, hbm_bytes=float(bytes_),
                      sol_time_s=roofline_time(flops, bytes_, chip),
                      chip=chip)


def cost_report(name: str, cost: KernelCost, measured_s: float) -> str:
    """One-line roofline audit (printed by the harness per run)."""
    return (f"[cost] {name}: {cost.gflops(measured_s):.1f} GFLOPS, "
            f"sol={cost.sol_time_s*1e6:.1f}us measured={measured_s*1e6:.1f}us "
            f"achieved={100*cost.achieved_fraction(measured_s):.1f}% "
            f"({cost.hbm_bytes/1e6:.2f} MB streamed)")
