"""Device-resident sparse layouts (static-shape jnp arrays) built from host
formats.

Jitted kernels need static shapes; every layout here pads to fixed
multiples and carries the true nnz for flop accounting (the reference counts
flops on the original CSR nnz regardless of format, spmv_bench.cpp:404-408).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.csr import CSRMatrix
from spgrid.formats.ell import csr_to_ell
from spgrid.formats.bsr import csr_to_bsr
from spgrid.formats.sell import csr_to_sell


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceCOO:
    """Sorted COO on device — for segment-sum SpMV/SpMM baselines."""

    rows: jax.Array      # (nnz_pad,) int32, padded with m (out-of-range)
    cols: jax.Array      # (nnz_pad,) int32, padded with 0
    values: jax.Array    # (nnz_pad,) dtype, padded with 0
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.rows, self.cols, self.values), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, pad_multiple: int = 128) -> "DeviceCOO":
        nnz_pad = _round_up(max(csr.nnz, 1), pad_multiple)
        rows = np.full(nnz_pad, csr.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=csr.values.dtype)
        rows[: csr.nnz] = np.repeat(np.arange(csr.m, dtype=np.int32), csr.degrees)
        cols[: csr.nnz] = csr.col_idx
        vals[: csr.nnz] = csr.values
        return cls(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                   csr.shape, csr.nnz)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceELL:
    """Padded ELL on device: (m_pad, w) cols/vals. Pad cols point at 0 with
    value 0, so they contribute nothing."""

    cols: jax.Array      # (m_pad, w) int32
    values: jax.Array    # (m_pad, w) dtype
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.cols, self.values), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, row_multiple: int = 8,
                 width_multiple: int = 8,
                 max_bytes: int = 4 << 30) -> "DeviceELL":
        # ELL width = max row degree: a skewed matrix (one 5000-nnz row)
        # would silently allocate m*width dense-scale arrays and OOM the
        # device; fail fast instead so sweeps can skip cleanly.
        width = int(np.diff(csr.row_ptr).max(initial=1))
        slots = csr.m * width
        est = slots * (4 + csr.values.dtype.itemsize)
        # the slot-waste ratio alone doesn't make a matrix unrunnable: a
        # tiny matrix with many empty rows wastes 32x on a few MB, which is
        # harmless — gate on waste only when the padding is also big
        if est > max_bytes or (slots > 32 * max(csr.nnz, 1)
                               and est > 64 << 20):
            raise ValueError(
                f"ELL padding would need {slots} slots for {csr.nnz} nnz "
                f"(~{est/2**30:.2f} GiB, width={width}); matrix too skewed "
                f"for ELL — use SELL-C-sigma or gell")
        ell = csr_to_ell(csr, pad_multiple=width_multiple)
        m_pad = _round_up(csr.m, row_multiple)
        cols = np.zeros((m_pad, ell.width), dtype=np.int32)
        vals = np.zeros((m_pad, ell.width), dtype=csr.values.dtype)
        cols[: csr.m] = ell.cols
        vals[: csr.m] = ell.values
        return cls(jnp.asarray(cols), jnp.asarray(vals), csr.shape, csr.nnz)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceBSR:
    """Flattened block-sparse rows on device, sorted by block row.

    ``block_rows[b]``/``block_cols[b]`` give the block-grid coordinates of
    dense block ``blocks[b]`` (bm, bk).  ``row_starts`` is true
    block_row_ptr.  Padding blocks (to ``pad_multiple``) carry row = mb
    (one past the last block row), col = 0, values = 0; kernels mask them.
    """

    block_rows: jax.Array   # (nb_pad,) int32
    block_cols: jax.Array   # (nb_pad,) int32
    row_starts: jax.Array   # (mb+1,) int32
    blocks: jax.Array       # (nb_pad, bm, bk)
    shape: Tuple[int, int]  # logical (m, k)
    nnz: int
    num_blocks: int         # true block count

    def tree_flatten(self):
        return ((self.block_rows, self.block_cols, self.row_starts, self.blocks),
                (self.shape, self.nnz, self.num_blocks))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def bm(self) -> int:
        return self.blocks.shape[1]

    @property
    def bk(self) -> int:
        return self.blocks.shape[2]

    @property
    def mb(self) -> int:
        return len(self.row_starts) - 1

    @classmethod
    def from_csr(cls, csr: CSRMatrix, bm: int = 8, bk: int = 128,
                 pad_multiple: int = 1) -> "DeviceBSR":
        bsr = csr_to_bsr(csr, bm=bm, bk=bk)
        brows = np.repeat(np.arange(bsr.mb, dtype=np.int32),
                          np.diff(bsr.block_row_ptr))
        nb = bsr.num_blocks
        nb_pad = _round_up(max(nb, 1), pad_multiple)
        rows = np.full(nb_pad, bsr.mb, dtype=np.int32)
        cols = np.zeros(nb_pad, dtype=np.int32)
        blocks = np.zeros((nb_pad, bm, bk), dtype=csr.values.dtype)
        rows[:nb] = brows
        cols[:nb] = bsr.block_col_idx
        blocks[:nb] = bsr.blocks
        return cls(
            block_rows=jnp.asarray(rows),
            block_cols=jnp.asarray(cols),
            row_starts=jnp.asarray(bsr.block_row_ptr, dtype=jnp.int32),
            blocks=jnp.asarray(blocks),
            shape=csr.shape,
            nnz=csr.nnz,
            num_blocks=nb,
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceSELL:
    """SELL-C-sigma on device: per width-bucket padded arrays + permutation."""

    perm: jax.Array                 # (m_pad,) int32 original row of slot i
    bucket_cols: tuple              # tuple of (s, C, w) int32
    bucket_vals: tuple              # tuple of (s, C, w) dtype
    bucket_slice_rows: tuple        # tuple of (s,) int32 first slot of slice
    shape: Tuple[int, int]
    nnz: int
    C: int

    def tree_flatten(self):
        return ((self.perm, self.bucket_cols, self.bucket_vals,
                 self.bucket_slice_rows),
                (self.shape, self.nnz, self.C))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, C: int = 8, sigma: int = 256) -> "DeviceSELL":
        sell = csr_to_sell(csr, C=C, sigma=sigma)
        m_pad = _round_up(csr.m, C)
        # Padding slots get unique out-of-range rows (m..m_pad-1) so the
        # un-permute scatter never collides with real rows.
        perm = np.arange(m_pad, dtype=np.int32)
        perm[: csr.m] = sell.perm
        return cls(
            perm=jnp.asarray(perm),
            bucket_cols=tuple(jnp.asarray(b.cols) for b in sell.buckets),
            bucket_vals=tuple(jnp.asarray(b.values) for b in sell.buckets),
            bucket_slice_rows=tuple(jnp.asarray(b.slice_rows) for b in sell.buckets),
            shape=csr.shape,
            nnz=csr.nnz,
            C=C,
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceCSC:
    """Column-major sorted COO on device — the CSC traversal order.

    The reference's CSC kernels (spmv_kernel_mkl_csc.cpp; lib/storage_formats/
    csc) walk columns and scatter into y; on the device this becomes a gather of x
    in column order + an (unsorted-segment) scatter-add over rows.  Padding
    entries carry row = m (out of range), col = 0, value = 0.
    """

    rows: jax.Array      # (nnz_pad,) int32, column-major order
    cols: jax.Array      # (nnz_pad,) int32, non-decreasing
    values: jax.Array    # (nnz_pad,) dtype
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.rows, self.cols, self.values), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_csc(cls, csc, pad_multiple: int = 128) -> "DeviceCSC":
        nnz_pad = _round_up(max(csc.nnz, 1), pad_multiple)
        rows = np.full(nnz_pad, csc.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=csc.values.dtype)
        rows[: csc.nnz] = csc.row_idx
        cols[: csc.nnz] = np.repeat(
            np.arange(csc.k, dtype=np.int32), csc.col_degrees)
        vals[: csc.nnz] = csc.values
        return cls(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                   csc.shape, csc.nnz)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, pad_multiple: int = 128) -> "DeviceCSC":
        from spgrid.formats.csc import csr_to_csc
        return cls.from_csc(csr_to_csc(csr), pad_multiple=pad_multiple)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceLDU:
    """LDU face lists on device (ref: ARM spmv_kernel_ldu.cpp:63-69).

    Padding faces carry owner = neigh = n_cells (out of range), values 0.
    """

    owner: jax.Array    # (nf_pad,) int32
    neigh: jax.Array    # (nf_pad,) int32
    lower: jax.Array    # (nf_pad,) dtype
    upper: jax.Array    # (nf_pad,) dtype
    diag: jax.Array     # (n_cells,) dtype
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return ((self.owner, self.neigh, self.lower, self.upper, self.diag),
                (self.shape, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_ldu(cls, ldu, pad_multiple: int = 128) -> "DeviceLDU":
        nf = ldu.n_faces
        nf_pad = _round_up(max(nf, 1), pad_multiple)
        n = ldu.n_cells
        owner = np.full(nf_pad, n, dtype=np.int32)
        neigh = np.full(nf_pad, n, dtype=np.int32)
        lower = np.zeros(nf_pad, dtype=ldu.lower.dtype)
        upper = np.zeros(nf_pad, dtype=ldu.upper.dtype)
        owner[:nf] = ldu.owner
        neigh[:nf] = ldu.neigh
        lower[:nf] = ldu.lower
        upper[:nf] = ldu.upper
        return cls(jnp.asarray(owner), jnp.asarray(neigh), jnp.asarray(lower),
                   jnp.asarray(upper), jnp.asarray(ldu.diag), ldu.shape,
                   ldu.nnz)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceCV:
    """Compressed-value COO on device (ref: lib/bitstream.c CV substrate;
    see spgrid.formats.cv).  int8 values + per-row f32 scales, or bf16
    values with an empty scale array.  Padding rows = m, values = 0."""

    rows: jax.Array      # (nnz_pad,) int32
    cols: jax.Array      # (nnz_pad,) int32
    qvalues: jax.Array   # (nnz_pad,) int8 | bf16
    scales: jax.Array    # (m+1,) f32 (int8) or (0,) (bf16)
    shape: Tuple[int, int]
    nnz: int
    mode: str

    def tree_flatten(self):
        return ((self.rows, self.cols, self.qvalues, self.scales),
                (self.shape, self.nnz, self.mode))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_cv(cls, cv, pad_multiple: int = 128) -> "DeviceCV":
        nnz_pad = _round_up(max(cv.nnz, 1), pad_multiple)
        rows = np.full(nnz_pad, cv.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        q = np.zeros(nnz_pad, dtype=cv.qvalues.dtype)
        rows[: cv.nnz] = np.repeat(np.arange(cv.m, dtype=np.int32), cv.degrees)
        cols[: cv.nnz] = cv.col_idx
        q[: cv.nnz] = cv.qvalues
        if cv.mode == "int8":
            # one extra slot so padding rows (= m) gather scale 0
            scales = np.append(cv.scales, 0.0).astype(np.float32)
        else:
            scales = np.zeros(0, dtype=np.float32)
        return cls(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(q),
                   jnp.asarray(scales), cv.shape, cv.nnz, cv.mode)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, mode: str = "int8",
                 pad_multiple: int = 128) -> "DeviceCV":
        from spgrid.formats.cv import csr_to_cv
        return cls.from_cv(csr_to_cv(csr, mode), pad_multiple=pad_multiple)
