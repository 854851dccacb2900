"""Vertical-panel block-sparse SpMM in plain jnp.

The unit of work is a vertical panel: all R rows of a row *band* for one
bk-wide block column, stored dense and skipped entirely when empty.  The
band's nonempty panels sit side by side, so one band is one dense product

  Y[band] (R, n) = panels[band] (R, max_p*bk) @ X tiles[band] (max_p*bk, n)

with X's (bk, n) tiles gathered by the panels' block columns; XLA runs all
bands as one batched matrix product.

This serves *mid-density and column-structured* sparsity — the regime the
reference serves with MKL-IE/BSR (spmm_kernel_mkl_ie.cpp, mkl_bsr
targets): dense-matmul throughput where the matrix is locally dense, with
whole-panel skipping where it is not.

Memory cost: R*bk bytes-per-value for each nonempty panel — between BSR and
dense; the framework's mem_footprint accounting reports it honestly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.csr import CSRMatrix
from spgrid.ops.layouts import _round_up


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DevicePanels:
    """Nonempty (band, block-col) vertical panels, band-major col-sorted.

    Bands are padded to ``max_p`` panel slots; pad slots hold zero panels
    (and block column 0)."""

    block_cols: jax.Array    # (bands*max_p,) int32
    panels: jax.Array        # (bands, R, max_p, bk)
    shape: Tuple[int, int]
    nnz: int
    num_panels: int          # true panel count
    band_rows: int           # R
    bands: int
    max_p: int

    def tree_flatten(self):
        return ((self.block_cols, self.panels),
                (self.shape, self.nnz, self.num_panels, self.band_rows,
                 self.bands, self.max_p))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def bk(self) -> int:
        return self.panels.shape[3]

    @classmethod
    def from_csr(cls, csr: CSRMatrix, bk: int = 128,
                 band_rows: int = 2048,
                 max_bytes: int = 4 << 30) -> "DevicePanels":
        m, k = csr.shape
        R = min(band_rows, _round_up(max(m, 8), 8))
        bands = -(-m // R)
        kb = -(-k // bk)
        rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
        cols = csr.col_idx.astype(np.int64)
        band = rows // R
        key = band * kb + cols // bk
        uniq, inv = np.unique(key, return_inverse=True)
        num_panels = len(uniq)
        # fail fast before allocating: scattered matrices make nearly every
        # (R, bk) panel nonempty and the panels array approaches the dense
        # footprint
        est = num_panels * R * bk * csr.values.dtype.itemsize
        if est > max_bytes:
            raise ValueError(
                f"panels would need ~{est/2**30:.1f} GiB "
                f"({num_panels} nonempty (R={R}, bk={bk}) panels); "
                f"matrix too scattered for the panel layout")
        u_band = uniq // kb
        u_col = (uniq % kb).astype(np.int32)
        counts = np.bincount(u_band, minlength=bands)
        max_p = max(int(counts.max(initial=1)), 1)
        starts = np.concatenate([[0], np.cumsum(counts)])
        # position of panel i inside its band (panels sorted by (band, col))
        pos = np.arange(num_panels) - starts[u_band]

        pcols = np.zeros(bands * max_p, dtype=np.int32)
        pcols[u_band * max_p + pos] = u_col
        panels = np.zeros((bands, R, max_p, bk), dtype=csr.values.dtype)
        panels[band, rows % R, pos[inv], cols % bk] = csr.values
        return cls(
            block_cols=jnp.asarray(pcols),
            panels=jnp.asarray(panels),
            shape=csr.shape,
            nnz=csr.nnz,
            num_panels=num_panels,
            band_rows=R,
            bands=bands,
            max_p=max_p,
        )


@jax.jit
def panel_spmm(a: DevicePanels, x: jax.Array) -> jax.Array:
    """Y = A @ X with A as vertical panels (see module doc).

    bf16 panels (cv_panel) multiply a bf16 copy of X: exact bf16 products
    summed in f32, the representation the cv_panel accuracy gate assumes."""
    bands, R, max_p, bk = a.panels.shape
    m, k = a.shape
    n = x.shape[1]
    kb = -(-k // bk)
    xt = jnp.pad(x, ((0, kb * bk - k), (0, 0))).reshape(kb, bk, n)
    xg = jnp.take(xt, a.block_cols, axis=0).reshape(bands, max_p, bk, n)
    xg = xg.astype(a.panels.dtype)
    y = jnp.einsum("brpk,bpkn->brn", a.panels, xg,
                   preferred_element_type=jnp.float32)
    return y.reshape(bands * R, n)[:m].astype(x.dtype)
