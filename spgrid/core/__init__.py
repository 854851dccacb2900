"""Core runtime utilities: config, RNG, timing, error metrics, roofline."""

from spgrid.core.config import BenchConfig
from spgrid.core.metrics import (
    ErrorMetrics,
    error_metrics,
    accuracy_gate,
    kahan_sum,
)
from spgrid.core.timing import TimedResult, time_kernel
from spgrid.core.roofline import ChipSpec, H100_SXM, roofline_time, roofline_fraction

__all__ = [
    "BenchConfig",
    "ErrorMetrics",
    "error_metrics",
    "accuracy_gate",
    "kahan_sum",
    "TimedResult",
    "time_kernel",
    "ChipSpec",
    "H100_SXM",
    "roofline_time",
    "roofline_fraction",
]

from spgrid.core.profile import (  # noqa: E402
    trace, annotate, KernelCost, spmm_cost, cost_report,
)

__all__ += ["trace", "annotate", "KernelCost", "spmm_cost", "cost_report"]
