"""SCOO: column-windowed COO SpMM — the scattered-hypersparse kernel.

Targets the regime the windowed gather-ELL (ops/gell.py) cannot reach:
matrices whose rows have no column locality (avg bandwidth a large
fraction of k) with k large enough that X outgrows the last-level cache,
where the gather rate falls (the `gather_fast`/`gather_slow` probes of
`chip_smoke.py --calibrate`).  The reference covers this
class with inspector-executor CSR on CPU caches
(spmm_kernel_mkl_ie.cpp:75-104; EPYC lands 105-328 GFLOPS on
scircuit/mac_econ-class matrices, amd-64/n=512/mkl_ie_f.csv:2-3) — caches
give EPYC full-bandwidth random 2KB reads; the device equivalent is
keeping every gather source a bounded window of X.

Design: a two-level blocking, entries sorted by (row-chunk, col-window):

  for each row chunk i (R rows):              # outer lax.scan, stacked y
    y_i = 0                                   # (R, n) carry
    for each col window j (W cols):           # inner lax.scan
      xw  = dynamic_slice(x, j*W)             # (W, n): bounded source
      g   = take(xw, local_cols[i,j])         # gather from the window
      y_i += combine(local_rows[i,j], vals[i,j] * g)

Entries are padded per (i, j) block to a shared slot count E; pad
entries point at local row R (a sacrificial row) with value 0, so padding
never perturbs the result.  E is NOT the global max block population —
one heavy block (row skew, the mawi class) would inflate gather work and
memory nb*ns-fold across the whole matrix.  Instead E minimizes
padded-slot work plus a weighted spill term; overflow entries spill to a
small plain COO tail combined after the scan with a full-source gather
(slow rate, but only the heavy-block excess pays it).  For uniformly scattered matrices the
fill is high (population is ~binomial around nnz/(nb*ns)); strongly
banded matrices belong to gell's windowed path instead (cost model
decides).

The per-block combine is a sorted segment-sum by local row.  The products
are cut from the gather by an optimization barrier before the scatter-add
— the same correctness barrier as gell's tail (gell.py::_add_tail).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.csr import CSRMatrix


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_pytree_node_class
class DeviceSCOO:
    """(nb, ns, E) padded block-COO with window-local coordinates."""

    def tree_flatten(self):
        return ((self.rows, self.cols, self.values,
                 self.srows, self.scols, self.svalues),
                (self.shape, self.nnz, self.plan, self.name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.rows, obj.cols, obj.values,
         obj.srows, obj.scols, obj.svalues) = children
        (obj.shape, obj.nnz, obj.plan, obj.name) = aux
        return obj

    def __init__(self, csr: CSRMatrix, chunk_rows: int = 1 << 15,
                 window_cols: int = 1 << 15):
        m, k = csr.shape
        R = min(chunk_rows, _round_up(max(m, 8), 8))
        W = min(window_cols, k)
        nb = -(-m // R)
        ns = -(-k // W)
        rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
        cols = csr.col_idx.astype(np.int64)
        vals = csr.values.astype(np.float32)
        blk = (rows // R) * ns + cols // W
        order = np.argsort(blk, kind="stable")
        rows, cols, vals, blk = (rows[order], cols[order], vals[order],
                                 blk[order])
        counts = np.bincount(blk, minlength=nb * ns)
        # two-tier E (module doc): pick the slot cap minimizing
        #   nb*ns*E  (padded fast-gather + scatter slots)
        # + SPILL_W * spill(E)  (overflow entries: full-source slow
        #   gather, ~gather_fast/gather_slow ~ 4x, plus their own
        #   scatter pass — weight 8 covers both)
        # so one heavy block (row skew) never inflates the whole tensor,
        # while uniform matrices keep E ~ max and an empty tail.
        SPILL_W = 8
        cands = np.unique(np.concatenate(([8], counts[counts >= 8])))
        spills = np.array([np.maximum(counts - int(e), 0).sum()
                           for e in cands], dtype=np.int64)
        E = int(cands[np.argmin(nb * ns * cands + SPILL_W * spills)])
        off = np.zeros(nb * ns + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        pos = np.arange(csr.nnz, dtype=np.int64) - off[blk]
        keep = pos < E
        slot = pos[keep] + blk[keep] * E
        lrow = np.full(nb * ns * E, R, np.int32)      # pad -> sacrificial row
        lcol = np.zeros(nb * ns * E, np.int32)
        lval = np.zeros(nb * ns * E, np.float32)
        lrow[slot] = (rows[keep] % R).astype(np.int32)
        lcol[slot] = (cols[keep] % W).astype(np.int32)
        lval[slot] = vals[keep]
        # spill tail: global-coordinate COO, row-sorted, padded to x8
        # (pad entries carry value 0 so they contribute nothing)
        sp = ~keep
        so = np.argsort(rows[sp], kind="stable")
        srow = rows[sp][so].astype(np.int32)
        scol = cols[sp][so].astype(np.int32)
        sval = vals[sp][so]
        spad = _round_up(max(srow.size, 0), 8) if srow.size else 0
        # pad rows with m-1 (>= every sorted row) so indices_are_sorted
        # stays true; pad values are 0 so the add is a no-op
        self.srows = jnp.asarray(np.pad(srow, (0, spad - srow.size),
                                        constant_values=m - 1))
        self.scols = jnp.asarray(np.pad(scol, (0, spad - scol.size)))
        self.svalues = jnp.asarray(np.pad(sval, (0, spad - sval.size)))
        self.rows = jnp.asarray(lrow.reshape(nb, ns, E))
        self.cols = jnp.asarray(lcol.reshape(nb, ns, E))
        self.values = jnp.asarray(lval.reshape(nb, ns, E))
        self.shape = csr.shape
        self.nnz = csr.nnz
        self.plan = (nb, ns, R, W, E)
        self.name = csr.name

    @classmethod
    def from_csr(cls, csr: CSRMatrix, **kw) -> "DeviceSCOO":
        return cls(csr, **kw)

    @property
    def mem_footprint(self) -> int:
        return self.rows.size * 12 + self.srows.size * 12


@functools.partial(jax.jit, static_argnames=("m", "plan"))
def _scoo_spmm(rows, cols, vals, srows, scols, svals, x, *, m, plan):
    nb, ns, R, W, E = plan
    k, n = x.shape
    k_pad = _round_up(k, W)
    if k_pad != k:
        x = jnp.pad(x, ((0, k_pad - k), (0, 0)))

    def outer(_, blk):
        rb, cb, vb = blk

        def inner(y, wblk):
            rw, cw, vw, j = wblk
            xw = jax.lax.dynamic_slice(x, (j * W, 0), (W, n))
            g = jnp.take(xw, cw, axis=0)
            p = vw[:, None] * g
            # fusion cut: see module doc (a scatter-add miscompile seen
            # when multi-op gathers fused into the scatter operand)
            p = jax.lax.optimization_barrier(p)
            # in-place indexed scatter-add: only the E touched rows move
            # (y + segment_sum(...) would rewrite the whole (R, n) carry
            # every window step — an ns-fold y-traffic amplification)
            y = y.at[rw].add(p, indices_are_sorted=True)
            return y, 0

        # row R is the sacrificial row all padding entries point at
        y0 = jnp.zeros((R + 8, n), jnp.float32)
        yb, _ = jax.lax.scan(
            inner, y0, (rb, cb, vb, jnp.arange(ns, dtype=jnp.int32)))
        return 0, yb[:R]

    _, ys = jax.lax.scan(outer, 0, (rows, cols, vals))
    y = ys.reshape(nb * R, n)[:m]
    if srows.size:
        # heavy-block overflow (<=2% of nnz): row-sorted global COO with a
        # full-source gather — slow gather rate, negligible entry count
        g = jnp.take(x[:k], scols, axis=0)
        p = svals[:, None] * g
        p = jax.lax.optimization_barrier(p)
        y = y.at[srows].add(p, indices_are_sorted=True,
                            unique_indices=False)
    return y.astype(x.dtype)


def scoo_spmm(a: DeviceSCOO, x: jax.Array) -> jax.Array:
    """Y = A @ X; x may be (k,) or (k, n)."""
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    y = _scoo_spmm(a.rows, a.cols, a.values, a.srows, a.scols, a.svalues,
                   x2, m=a.shape[0], plan=a.plan)
    return y[:, 0] if squeeze else y
