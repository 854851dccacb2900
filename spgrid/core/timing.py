"""Timing harness: warm-up + timed loop protocol on device.

Reimplements the reference measurement protocol
(``spmv_code_bench/spmv_bench.cpp:316-380``): warm-up iterations, then a
timed loop until a minimum wall time.  Two hazards shape the design:

1. **Linearity hoisting.** Timing K applications of a *linear* kernel inside
   one jit with a scalar data dependence is void: XLA distributes
   ``dot(a, x + s·E)`` and hoists the loop-invariant matmul.  The chained
   loop therefore feeds the FULL output back into the next input, scaled by
   1e-30 (exact identity in f32/bf16 arithmetic, opaque to the algebraic
   simplifier).

2. **Fixed overheads.** Dispatch is asynchronous and a call carries fixed
   launch and fetch costs.  Every measurement ends with a scalar fetch (a
   true barrier on any platform), and the per-iteration time is obtained
   by *differencing* two loop lengths, which cancels those fixed costs.
   What it does not cancel is the loop's own per-iteration cost: on the
   H100 a dynamic-trip-count loop pays ~19 us per iteration (the
   `dispatch` probe of chip_smoke.py --calibrate); the static protocol,
   unrolled by 4, pays it once per four calls.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class TimedResult:
    time_per_iter_s: float
    iters: int
    total_time_s: float
    flops: Optional[float] = None       # per-iteration flop count, if known
    bytes_accessed: Optional[float] = None

    @property
    def gflops(self) -> Optional[float]:
        if self.flops is None:
            return None
        return self.flops / self.time_per_iter_s / 1e9

    @property
    def gbytes_per_s(self) -> Optional[float]:
        if self.bytes_accessed is None:
            return None
        return self.bytes_accessed / self.time_per_iter_s / 1e9


def _sync_fetch(out) -> float:
    """True execution barrier: fetch one scalar of the result to host."""
    leaf = jax.tree_util.tree_leaves(out)[0]
    return float(jax.device_get(leaf.ravel()[0]))


def _feedback(y, x0):
    """Full-rank perturbation of x0 by y, numerically exact identity.

    1e-30·y underflows against x0's magnitude in f32/bf16, so x0 is bitwise
    unchanged for any reasonably scaled problem — but the dependence blocks
    loop-invariant hoisting and algebraic distribution of linear kernels."""
    leaf = jax.tree_util.tree_leaves(y)[0].astype(jnp.float32).ravel()
    need = x0.size
    if leaf.size < need:
        reps = -(-need // leaf.size)
        leaf = jnp.tile(leaf, reps)
    pert = leaf[:need].reshape(x0.shape)
    return x0 + (pert * 1e-30).astype(x0.dtype)


def _chained_runner(kernel_of_x: Callable, x: jax.Array, iters: int,
                    operands=None, many=None):
    # ``operands`` must carry any device arrays the kernel uses (the sparse
    # operand): a closure would bake them into the HLO as constants, which
    # bloats compile payloads enormously (observed: 70MB HLO -> remote
    # compile rejects).  With operands given, kernel is called as
    # kernel(operands, x).
    if many is None:
        many = _chained_many(kernel_of_x)
    it = jnp.asarray(iters, jnp.int32)
    return lambda x0: many(x0, it, operands)


def _chained_many(kernel_of_x: Callable):
    """One jit covering EVERY loop length: the trip count is a device
    scalar, so the fori_loop lowers to a single compiled while loop.

    This matters for sweep throughput: per-length jits mean 3-4 compiles
    per (matrix, kernel) row.
    A static-count fori_loop lowers to the same XLA while loop anyway (the
    body is one kernel call; there is no cross-iteration fusion to lose).
    """
    @jax.jit
    def many(x0, iters, operands):
        def body(i, xc):
            y = (kernel_of_x(xc) if operands is None
                 else kernel_of_x(operands, xc))
            return _feedback(y, x0)
        return jax.lax.fori_loop(0, iters, body, x0)

    return many


def _chained_many_static(kernel_of_x: Callable):
    """Per-length jits: the trip count is a static python int, so XLA
    sees a constant-bound loop with zero dynamic bookkeeping.

    The dynamic trip-count loop pays a per-iteration bookkeeping cost
    that is no part of the kernel (~19 us on the H100, the `dispatch`
    probe); deployment code jits with static bounds, so headline-scale
    measurements should too.
    Costs one compile per loop length — use for single rows, not sweeps.
    """
    @functools.lru_cache(maxsize=8)
    def of_len(iters: int):
        @jax.jit
        def many(x0, _iters_ignored, operands):
            def body(i, xc):
                y = (kernel_of_x(xc) if operands is None
                     else kernel_of_x(operands, xc))
                return _feedback(y, x0)
            return jax.lax.fori_loop(0, iters, body, x0,
                                     unroll=min(iters, 4))
        return many

    class _Dispatch:
        def __call__(self, x0, iters, operands):
            return of_len(int(iters))(x0, iters, operands)

    return _Dispatch()


def time_kernel_chained(
    kernel_of_x: Callable[..., jax.Array],
    x: jax.Array,
    *,
    operands=None,
    min_time_s: float = 0.5,
    base_iters: int = 4,
    flops: Optional[float] = None,
    bytes_accessed: Optional[float] = None,
    repeats: int = 3,
    per_iter_hint: Optional[float] = None,
    static_lengths: bool = False,
) -> TimedResult:
    """Differenced chained-loop timing (the default protocol).

    Measures t(I1) and t(I2) with the loop inside ONE jit (dynamic trip
    count); per-iteration time = (t(I2)-t(I1))/(I2-I1), cancelling fixed
    launch and fetch costs.  ``per_iter_hint`` (e.g. the dispatch cost model's
    estimate) seeds the loop-length escalation, usually collapsing it to a
    single probe.  ``static_lengths=True`` compiles one jit per loop
    length instead (see _chained_many_static): minimal per-iteration
    overhead, right for headline single-row measurements."""
    many = (_chained_many_static(kernel_of_x) if static_lengths
            else _chained_many(kernel_of_x))
    i1 = base_iters
    run1 = _chained_runner(kernel_of_x, x, i1, operands, many=many)
    _sync_fetch(run1(x))                       # compile + warm
    t0 = time.perf_counter()
    _sync_fetch(run1(x))
    t1 = time.perf_counter() - t0

    # Pick I2 so the long run actually spends >= min_time_s on device.
    # t1 at tiny i1 is dominated by fixed overheads, so a per-iter
    # estimate from it overshoots by orders of magnitude and would make the
    # "long" loop a few ms of pure jitter; escalate I2 until t2 >= min_time_s.
    per_est = max(t1 / i1 / 4, 1e-8)
    if per_iter_hint is not None and per_iter_hint > 0:
        per_est = max(min(per_iter_hint, per_est * 64), per_est / 64,
                      1e-8)
    i2 = 0
    t2 = 0.0
    esc_iters = 0          # executions spent escalating (2x i2 per round:
    esc_time = 0.0         # warm + timed), so the row's iters/total
    for _ in range(8):     # reflect actual measurement cost (ADVICE r1)
        i2_new = i1 + max(i1, min(int(min_time_s / per_est) + 1, 1 << 20))
        if i2_new <= i2:
            break
        i2 = i2_new
        run2 = _chained_runner(kernel_of_x, x, i2, operands, many=many)
        tw0 = time.perf_counter()
        _sync_fetch(run2(x))                   # warm (same jit, new length)
        t0 = time.perf_counter()
        _sync_fetch(run2(x))
        t2 = time.perf_counter() - t0
        esc_iters += 2 * i2                    # warm run + timed run
        esc_time += time.perf_counter() - tw0
        if t2 >= min_time_s * 0.9 or i2 >= 1 << 20:
            break
        per_est = max((t2 - t1) / (i2 - i1), t2 / i2 / 4, 1e-9)

    total = t1 + esc_time
    pers = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        _sync_fetch(run1(x))
        ta = time.perf_counter() - t0
        t0 = time.perf_counter()
        _sync_fetch(run2(x))
        tb = time.perf_counter() - t0
        total += ta + tb
        per = (tb - ta) / (i2 - i1)
        if per > 0:
            pers.append(per)
    # Median of the differenced estimates: robust to one-sided jitter spikes
    # without the systematic low bias a min would have.
    if pers:
        pers.sort()
        best = pers[len(pers) // 2]
    else:
        best = max(t2 / i2, 1e-9)
    return TimedResult(
        time_per_iter_s=best,
        iters=2 * i1 + esc_iters + (i1 + i2) * max(repeats, 1),
        total_time_s=total,
        flops=flops,
        bytes_accessed=bytes_accessed,
    )


def time_kernel(
    fn: Callable[[], jax.Array],
    *,
    warmup_iters: int = 10,
    min_time_s: float = 0.5,
    min_iters: int = 32,
    flops: Optional[float] = None,
    bytes_accessed: Optional[float] = None,
) -> TimedResult:
    """Per-call timing of a zero-arg closure (dispatch included).

    Uses batch differencing with a sync fetch per batch so async-relay
    platforms are measured truthfully.  Prefer time_kernel_chained for
    kernels faster than ~1 ms."""
    out = None
    for _ in range(max(warmup_iters, 1)):
        out = fn()
    _sync_fetch(out)

    def run_batch(b):
        t0 = time.perf_counter()
        out = None
        for _ in range(b):
            out = fn()
        _sync_fetch(out)
        return time.perf_counter() - t0

    b1 = max(1, min_iters // 4)
    t1 = run_batch(b1)
    per_est = max(t1 / b1 / 4, 1e-7)
    b2 = b1 + max(b1, min(int(min_time_s / per_est), 1 << 14))
    t2 = run_batch(b2)
    per = (t2 - t1) / (b2 - b1)
    if per <= 0:
        per = t2 / b2
    return TimedResult(
        time_per_iter_s=per,
        iters=b1 + b2,
        total_time_s=t1 + t2,
        flops=flops,
        bytes_accessed=bytes_accessed,
    )


@dataclasses.dataclass
class PhaseTimer:
    """Per-phase wall timers (read / convert / balance / compute).

    Mirrors the reference's phase prints (spmv_bench.cpp:666-768,989-999).
    """

    phases: dict = dataclasses.field(default_factory=dict)

    def __call__(self, name: str):
        return _Phase(self, name)

    def report(self) -> str:
        return ", ".join(f"{k}: {v:.4f}s" for k, v in self.phases.items())


class _Phase:
    def __init__(self, timer: PhaseTimer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.phases[self.name] = (
            self.timer.phases.get(self.name, 0.0) + time.perf_counter() - self.t0
        )
        return False
