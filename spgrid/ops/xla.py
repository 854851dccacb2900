"""XLA-native baseline kernels: SpMV / SpMM / SDDMM / GEMM bound.

These are the "library" kernels of the framework — the role MKL / cuSPARSE /
TACO play in the reference (spmm_kernel_mkl_ie.cpp, sddmm_taco.cpp): a
correct, always-available implementation on top of the vendor stack, here
XLA's fused gather / segment-sum / dot machinery.  The Pallas kernels in
spgrid.ops.pallas are the custom-kernel (Triton) counterparts.

All functions are jit-friendly (static shapes, no data-dependent control
flow) and accept/return committed device arrays.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from spgrid.ops.layouts import (
    DeviceCOO, DeviceELL, DeviceBSR, DeviceSELL, DeviceCSC, DeviceLDU,
    DeviceCV,
)


# --------------------------------------------------------------------------
# Dense GEMM bound (ref: spmm_kernel_mkl_gemm.cpp — upper-bound baseline)
# --------------------------------------------------------------------------

def _acc_dtype(x):
    """f32 accumulation except for f64 inputs (the f64 correctness leg)."""
    return jnp.float64 if x.dtype == jnp.float64 else jnp.float32


@jax.jit
def gemm(a: jax.Array, x: jax.Array) -> jax.Array:
    return jnp.dot(a, x, preferred_element_type=_acc_dtype(x)) \
        .astype(x.dtype)


@jax.jit
def spmm_dense(a_dense: jax.Array, x: jax.Array) -> jax.Array:
    """Densified SpMM: the sparse matrix materialized dense.

    For DLMC-class matrices (~50% dense) this runs at full matmul rate and
    is the honest analogue of "just call the vendor GEMM"; flops are still
    accounted sparse (2*nnz*n)."""
    return jnp.dot(a_dense, x,
                   preferred_element_type=_acc_dtype(x)).astype(x.dtype)


# --------------------------------------------------------------------------
# COO segment-sum kernels (ref: naive CSR loops, spmm_kernel_csr.cpp:70-97)
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("m",))
def _spmv_coo(rows, cols, vals, x, m):
    prods = vals * jnp.take(x, cols, axis=0, fill_value=0)
    return jax.ops.segment_sum(prods, rows, num_segments=m + 1)[:m]


def spmv_coo(coo: DeviceCOO, x: jax.Array) -> jax.Array:
    """y = A @ x via gather + segment_sum. Padding rows land in segment m."""
    return _spmv_coo(coo.rows, coo.cols, coo.values, x, coo.shape[0])


@partial(jax.jit, static_argnames=("m",))
def _spmm_coo(rows, cols, vals, x, m):
    prods = vals[:, None] * jnp.take(x, cols, axis=0, fill_value=0)
    return jax.ops.segment_sum(prods, rows, num_segments=m + 1)[:m]


def spmm_coo(coo: DeviceCOO, x: jax.Array) -> jax.Array:
    """Y = A @ X via gather + segment_sum over nnz."""
    return _spmm_coo(coo.rows, coo.cols, coo.values, x, coo.shape[0])


# --------------------------------------------------------------------------
# ELL kernels — the padded-gather formulation (ref: spmv_kernel_ell.cpp)
# --------------------------------------------------------------------------

def spmv_ell(ell: DeviceELL, x: jax.Array) -> jax.Array:
    return _spmv_ell(ell.cols, ell.values, x, ell.shape[0])


@partial(jax.jit, static_argnames=("m",))
def _spmv_ell(cols, vals, x, m):
    gathered = jnp.take(x, cols, axis=0, fill_value=0)      # (m_pad, w)
    return jnp.sum(vals * gathered, axis=1)[:m]


def spmm_ell(ell: DeviceELL, x: jax.Array, row_block: int = 256) -> jax.Array:
    return _spmm_ell(ell.cols, ell.values, x, ell.shape[0], row_block)


@partial(jax.jit, static_argnames=("m", "row_block"))
def _spmm_ell(cols, vals, x, m, row_block):
    """Y = A @ X from ELL: per row-block gather X rows then contract width.

    Blocked over rows with lax.map so the (rb, w, n) gather intermediate
    stays small instead of materializing (m, w, n) in device memory."""
    m_pad, w = cols.shape
    n = x.shape[1]
    rb = min(row_block, m_pad)
    nb = -(-m_pad // rb)
    pad = nb * rb - m_pad
    if pad:
        cols = jnp.pad(cols, ((0, pad), (0, 0)))
        vals = jnp.pad(vals, ((0, pad), (0, 0)))
    cols_b = cols.reshape(nb, rb, w)
    vals_b = vals.reshape(nb, rb, w)

    def block(args):
        cb, vb = args
        g = jnp.take(x, cb.reshape(-1), axis=0, fill_value=0).reshape(rb, w, n)
        return jnp.einsum("rw,rwn->rn", vb, g,
                          preferred_element_type=_acc_dtype(x)).astype(x.dtype)

    y = jax.lax.map(block, (cols_b, vals_b))
    return y.reshape(nb * rb, n)[:m]


# --------------------------------------------------------------------------
# BSR kernel — batched dense blocks through the matrix units
# --------------------------------------------------------------------------

def spmm_bsr(bsr: DeviceBSR, x: jax.Array) -> jax.Array:
    return _spmm_bsr(bsr.block_rows, bsr.block_cols, bsr.blocks, x,
                     bsr.mb, bsr.shape[0])


@partial(jax.jit, static_argnames=("mb", "m"))
def _spmm_bsr(block_rows, block_cols, blocks, x, mb, m):
    nb, bm, bk = blocks.shape
    n = x.shape[1]
    kb = -(-x.shape[0] // bk)
    if kb * bk != x.shape[0]:
        x = jnp.pad(x, ((0, kb * bk - x.shape[0]), (0, 0)))
    xb = x.reshape(kb, bk, n)
    gathered = jnp.take(xb, block_cols, axis=0, fill_value=0)   # (nb, bk, n)
    prods = jnp.einsum("bij,bjn->bin", blocks, gathered,
                       preferred_element_type=_acc_dtype(x))    # (nb, bm, n)
    out = jax.ops.segment_sum(prods, block_rows, num_segments=mb + 1)[:mb]
    return out.reshape(mb * bm, n)[:m].astype(x.dtype)


# --------------------------------------------------------------------------
# SELL-C-sigma SpMV — per-bucket gather, then un-permute
# --------------------------------------------------------------------------

@jax.jit
def spmv_sell(sell: DeviceSELL, x: jax.Array) -> jax.Array:
    m = sell.shape[0]
    m_pad = sell.perm.shape[0]
    parts = []
    for cols, vals, srows in zip(sell.bucket_cols, sell.bucket_vals,
                                 sell.bucket_slice_rows):
        s, C, w = cols.shape
        g = jnp.take(x, cols.reshape(-1), axis=0, fill_value=0).reshape(s, C, w)
        part = jnp.sum(vals * g, axis=2)                       # (s, C)
        parts.append((srows, part))
    y_perm = jnp.zeros((m_pad,), dtype=x.dtype)
    for srows, part in parts:
        s, C = part.shape
        idx = srows[:, None] + jnp.arange(C)[None, :]
        y_perm = y_perm.at[idx.reshape(-1)].add(part.reshape(-1).astype(x.dtype))
    # slot i holds original row perm[i]
    y = jnp.zeros((m_pad,), dtype=x.dtype).at[sell.perm].set(y_perm)
    return y[:m]


@jax.jit
def spmm_sell(sell: DeviceSELL, x: jax.Array) -> jax.Array:
    """Y = A @ X from SELL-C-sigma buckets (completes the format for SpMM;
    ref: spmv_code_sell-C-s/spmvbench/spmvbench.c:1-303).

    Per width-bucket: gather X rows for the (s, C, w) slot block, weighted
    sum over w, scatter slices back through the sigma-sort permutation.
    The permutation scatter is the price SELL pays relative to gell
    (ops/gell.py), which keeps rows in place and tails the skew.
    """
    m = sell.shape[0]
    n = x.shape[1]
    m_pad = sell.perm.shape[0]
    acc = _acc_dtype(x)
    y_perm = jnp.zeros((m_pad, n), dtype=acc)
    for cols, vals, srows in zip(sell.bucket_cols, sell.bucket_vals,
                                 sell.bucket_slice_rows):
        s, C, w = cols.shape
        g = jnp.take(x, cols.reshape(-1), axis=0, fill_value=0) \
            .reshape(s, C, w, n)
        part = jnp.sum(vals[..., None].astype(acc)
                       * g.astype(acc), axis=2)           # (s, C, n)
        idx = (srows[:, None] + jnp.arange(C)[None, :]).reshape(-1)
        y_perm = y_perm.at[idx].add(part.reshape(s * C, n))
    # slot i holds original row perm[i]
    y = jnp.zeros((m_pad, n), dtype=acc).at[sell.perm].set(y_perm)
    return y[:m].astype(x.dtype)


# --------------------------------------------------------------------------
# Compressed-value kernels (ref: lib/bitstream.c CV substrate; dequant on VPU)
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("m", "mode"))
def _spmm_cv(rows, cols, q, scales, x, m, mode):
    if mode == "int8":
        # scales has m+1 entries; padding rows (= m) gather scale 0
        vals = q.astype(jnp.float32) * jnp.take(scales, rows, fill_value=0)
    else:
        vals = q.astype(jnp.float32)
    prods = vals[:, None] * jnp.take(x, cols, axis=0, fill_value=0) \
        .astype(jnp.float32)
    return jax.ops.segment_sum(prods, rows, num_segments=m + 1)[:m] \
        .astype(x.dtype)


def spmm_cv(cv: DeviceCV, x: jax.Array) -> jax.Array:
    """Y = A @ X with A's values dequantized on the fly — halves (bf16) or
    quarters (int8) the streamed value bytes on an HBM-bound kernel."""
    return _spmm_cv(cv.rows, cv.cols, cv.qvalues, cv.scales, x,
                    cv.shape[0], cv.mode)


def spmv_cv(cv: DeviceCV, x: jax.Array) -> jax.Array:
    return spmm_cv(cv, x[:, None])[:, 0]


# --------------------------------------------------------------------------
# CSC kernels — column-major scatter formulation (ref: spmv_kernel_mkl_csc.cpp)
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("m",))
def _spmm_csc(rows, cols, vals, x, m):
    prods = vals[:, None] * jnp.take(x, cols, axis=0, fill_value=0)
    # rows are NOT sorted in column-major order — unsorted segment sum.
    return jax.ops.segment_sum(prods, rows, num_segments=m + 1,
                               indices_are_sorted=False)[:m]


def spmm_csc(csc: DeviceCSC, x: jax.Array) -> jax.Array:
    """Y = A @ X walking A column-major: gather x rows per column entry,
    scatter-add into output rows (the CSC SpMV idiom of the reference's MKL
    CSC kernel)."""
    return _spmm_csc(csc.rows, csc.cols, csc.values, x, csc.shape[0])


def spmv_csc(csc: DeviceCSC, x: jax.Array) -> jax.Array:
    return spmm_csc(csc, x[:, None])[:, 0]


# --------------------------------------------------------------------------
# LDU kernel — face-loop SpMV (ref: ARM spmv_kernel_ldu.cpp:63-69)
# --------------------------------------------------------------------------

@jax.jit
def _spmv_ldu(owner, neigh, lower, upper, diag, x):
    n = diag.shape[0]
    y = diag * x
    xo = jnp.take(x, owner, fill_value=0)
    xn = jnp.take(x, neigh, fill_value=0)
    y = y + jax.ops.segment_sum(upper * xn, owner, num_segments=n + 1)[:n]
    y = y + jax.ops.segment_sum(lower * xo, neigh, num_segments=n + 1,
                                indices_are_sorted=False)[:n]
    return y


def spmv_ldu(ldu: DeviceLDU, x: jax.Array) -> jax.Array:
    """y = A @ x from LDU face lists: y = diag*x; per face f,
    y[owner] += upper[f]*x[neigh], y[neigh] += lower[f]*x[owner]."""
    return _spmv_ldu(ldu.owner, ldu.neigh, ldu.lower, ldu.upper, ldu.diag, x)


@jax.jit
def _spmm_ldu(owner, neigh, lower, upper, diag, x):
    n = diag.shape[0]
    y = diag[:, None] * x
    xo = jnp.take(x, owner, axis=0, fill_value=0)
    xn = jnp.take(x, neigh, axis=0, fill_value=0)
    y = y + jax.ops.segment_sum(upper[:, None] * xn, owner,
                                num_segments=n + 1)[:n]
    y = y + jax.ops.segment_sum(lower[:, None] * xo, neigh,
                                num_segments=n + 1)[:n]
    return y


def spmm_ldu(ldu: DeviceLDU, x: jax.Array) -> jax.Array:
    return _spmm_ldu(ldu.owner, ldu.neigh, ldu.lower, ldu.upper, ldu.diag, x)


# --------------------------------------------------------------------------
# SDDMM — masked Q @ K^T (ref: sddmm_taco_naive.cpp:98-140)
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def _sddmm_coo(rows, cols, mask_vals, q, kt):
    qg = jnp.take(q, rows, axis=0, fill_value=0)    # (nnz, d)
    kg = jnp.take(kt, cols, axis=0, fill_value=0)   # (nnz, d)
    dots = jnp.sum(qg.astype(jnp.float32) * kg.astype(jnp.float32), axis=1)
    return (dots * mask_vals).astype(q.dtype)


def sddmm_coo(mask: DeviceCOO, q: jax.Array, k: jax.Array) -> jax.Array:
    """values[p] = mask_val[p] * sum_d Q[row_p, d] * K[col_p, d].

    Matches the taco-naive semantics: dot over the dense width, then scaled
    by the mask value (sddmm_taco_naive.cpp:118-137)."""
    return _sddmm_coo(mask.rows, mask.cols, mask.values, q, k)


@jax.jit
def _sddmm_bsr(block_rows, block_cols, blocks, q, k):
    nb, bm, bk = blocks.shape
    # one spare row panel of zeros for padding blocks (block_row = mb)
    mbq = -(-q.shape[0] // bm) + 1
    mbk = -(-k.shape[0] // bk)
    qp = jnp.pad(q, ((0, mbq * bm - q.shape[0]), (0, 0))).reshape(mbq, bm, -1)
    kp = jnp.pad(k, ((0, mbk * bk - k.shape[0]), (0, 0))).reshape(mbk, bk, -1)
    qg = jnp.take(qp, block_rows, axis=0, fill_value=0)   # (nb, bm, d)
    kg = jnp.take(kp, block_cols, axis=0, fill_value=0)   # (nb, bk, d)
    dots = jnp.einsum("bid,bjd->bij", qg, kg,
                      preferred_element_type=jnp.float32)
    return (dots * blocks.astype(jnp.float32)).astype(q.dtype)


def sddmm_bsr(mask: DeviceBSR, q: jax.Array, k: jax.Array) -> jax.Array:
    """Block values of mask ⊙ (Q @ K^T) on BSR mask blocks: gathers the
    Q and K row panels of every block, then one batched product."""
    return _sddmm_bsr(mask.block_rows, mask.block_cols, mask.blocks, q, k)


@jax.jit
def sddmm_dense(mask_dense: jax.Array, q: jax.Array, k: jax.Array) -> jax.Array:
    """Dense formulation: mask ⊙ (Q @ K^T) — matmul-bound when the mask is
    dense enough; returns the dense masked score matrix."""
    scores = jnp.dot(q, k.T, preferred_element_type=jnp.float32)
    return (mask_dense * scores).astype(q.dtype)
