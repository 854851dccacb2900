"""Sparse kernels: XLA baselines + Pallas GPU kernels + pipeline + dispatch."""

from spgrid.ops.layouts import (
    DeviceCOO, DeviceELL, DeviceBSR, DeviceSELL, DeviceCSC, DeviceLDU,
    DeviceCV,
)
from spgrid.ops.xla import (
    gemm,
    spmm_dense,
    spmv_coo,
    spmm_coo,
    spmv_ell,
    spmm_ell,
    spmm_bsr,
    spmv_sell,
    spmv_csc,
    spmm_csc,
    spmv_ldu,
    spmm_ldu,
    spmv_cv,
    spmm_cv,
    sddmm_bsr,
    sddmm_coo,
    sddmm_dense,
)
from spgrid.ops.pallas.bsr_spmm import bsr_spmm
from spgrid.ops.panels import DevicePanels, panel_spmm
from spgrid.ops.attention import (
    SparseAttention,
    attention_pipeline,
    make_pipeline_step,
    gold_pipeline,
    blocksparse_softmax,
)
from spgrid.ops.dispatch import select_format, autotune_spmm, build, spmm_fn

__all__ = [
    "DeviceCOO", "DeviceELL", "DeviceBSR", "DeviceSELL", "DeviceCSC",
    "DeviceLDU", "DeviceCV",
    "gemm", "spmm_dense", "spmv_coo", "spmm_coo", "spmv_ell", "spmm_ell",
    "spmm_bsr", "spmv_sell", "spmv_csc", "spmm_csc", "spmv_ldu", "spmm_ldu",
    "spmv_cv", "spmm_cv", "sddmm_bsr", "sddmm_coo", "sddmm_dense",
    "bsr_spmm", "DevicePanels", "panel_spmm",
    "SparseAttention", "attention_pipeline", "make_pipeline_step",
    "gold_pipeline", "blocksparse_softmax",
    "select_format", "autotune_spmm", "build", "spmm_fn",
]
