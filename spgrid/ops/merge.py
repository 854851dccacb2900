"""Merge-path SpMM: perfect nnz balance for arbitrarily skewed matrices.

Re-designs the reference's merge-based CSR SpMV (SURVEY A.3:
``benchmark_code/CPU/ARM/spmv_code_bench/spmv_kernel_csr.cpp:68-110,624-680``
and the Merrill/Garland ``merge/cpu_spmv.cpp`` port): the nnz stream is cut
into equal blocks regardless of row boundaries, each block contributes
partials, and boundary rows are fixed up in a segmented epilogue.

Device re-design (no per-thread binary search — the balance comes from
the *layout*):

- `merge_path_blocks` (formats/partition.py) cuts [0, nnz) into blocks of
  T nonzeros.  A block additionally never spans more than 128 distinct
  rows (blocks crossing that are cut early), so each block's scatter is a
  (128, T) matmul.
- Per block, the gathered X rows (T, n) are reduced into the block's
  <=128 local rows by a value-weighted one-hot matmul —
  A_blk[r_local, t] = v[t] * [row_local[t] == r_local] — run at the
  ambient matmul precision (the harness forces HIGHEST for f32, keeping
  the kernel oracle-exact).  The one-hot flop padding is the price of
  balance; gell stays the throughput kernel, merge the skew-proof one.
- Block partials land in a (B*128, n) strip; a sorted segment-sum over
  host-precomputed global row ids performs the merge-path carry fix-up.

Every step is O(nnz/T) balanced work regardless of skew — one 5M-nnz row
costs exactly as much as 5M singleton rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.csr import CSRMatrix

ROWS_CAP = 128
_CHUNK_BYTES = 1 << 28      # gathered-intermediate budget per scan chunk


@jax.tree_util.register_pytree_node_class
class DeviceMerge:
    """Equal-nnz blocks: cols (B, T), weighted one-hot rows via locals."""

    def tree_flatten(self):
        return ((self.cols, self.values, self.local_rows, self.out_rows),
                (self.shape, self.nnz, self.block_nnz, self.name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.cols, obj.values, obj.local_rows, obj.out_rows = children
        obj.shape, obj.nnz, obj.block_nnz, obj.name = aux
        return obj

    def __init__(self, csr: CSRMatrix, block_nnz: int = 512):
        m, k = csr.shape
        T = block_nnz
        rows = np.repeat(np.arange(max(m, 1), dtype=np.int64), csr.degrees)
        cols = csr.col_idx.astype(np.int64)
        vals = np.asarray(csr.values)
        nnz = csr.nnz

        # cut points: every T nnz, plus early cuts so no block spans more
        # than ROWS_CAP distinct rows
        cuts = [0]
        while cuts[-1] < nnz:
            s = cuts[-1]
            e = min(s + T, nnz)
            # furthest e with rows[e-1] - rows[s] < ROWS_CAP
            limit_row = rows[s] + ROWS_CAP
            if e > s and rows[e - 1] >= limit_row:
                e = int(np.searchsorted(rows, limit_row, side="left"))
                e = max(e, s + 1)
            cuts.append(e)
        B = len(cuts) - 1
        starts = np.asarray(cuts[:-1], dtype=np.int64)

        cols_b = np.zeros((B, T), np.int32)
        vals_b = np.zeros((B, T), vals.dtype)
        locals_b = np.zeros((B, T), np.int32)
        base_rows = rows[starts] if nnz else np.zeros(B, np.int64)
        for b in range(B):
            s, e = cuts[b], cuts[b + 1]
            cols_b[b, : e - s] = cols[s:e]
            vals_b[b, : e - s] = vals[s:e]
            locals_b[b, : e - s] = rows[s:e] - base_rows[b]
        # global output row per (block, local): base + local, clipped into
        # a padding segment (m) for locals past the block's real span
        out_rows = np.minimum(base_rows[:, None]
                              + np.arange(ROWS_CAP, dtype=np.int64)[None, :],
                              m).astype(np.int32)

        self.cols = jnp.asarray(cols_b)
        self.values = jnp.asarray(vals_b)
        self.local_rows = jnp.asarray(locals_b)
        self.out_rows = jnp.asarray(out_rows.reshape(-1))
        self.shape = csr.shape
        self.nnz = nnz
        self.block_nnz = T
        self.name = csr.name

    @classmethod
    def from_csr(cls, csr: CSRMatrix, block_nnz: int = 512) -> "DeviceMerge":
        return cls(csr, block_nnz=block_nnz)

    @property
    def mem_footprint(self) -> int:
        return (self.cols.size * 12 + self.out_rows.size * 4)


@functools.partial(jax.jit, static_argnames=("m",))
def _merge_spmm(cols, vals, local_rows, out_rows, x, *, m):
    B, T = cols.shape
    k, n = x.shape
    acc = jnp.float64 if x.dtype == jnp.float64 else jnp.float32

    def block_y(cb, vb, lb, ob, nb):
        g = jnp.take(x, cb.reshape(-1), axis=0)        # (nb*T, n)
        # value-weighted one-hot scatter as a matmul at ambient precision
        onehot = jax.nn.one_hot(lb, ROWS_CAP, axis=1, dtype=acc)
        a = onehot * vb[:, None, :].astype(acc)
        parts = jax.lax.dot_general(
            a, g.reshape(nb, T, n).astype(acc),
            (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=acc)                 # (nb, 128, n)
        # out_rows is NOT globally sorted: consecutive blocks usually
        # start fewer than ROWS_CAP rows apart, so their 128-row strips
        # interleave, so the sorted-indices hint would be wrong here —
        # keep it off.
        return jax.ops.segment_sum(parts.reshape(nb * ROWS_CAP, n), ob,
                                   num_segments=m + 1,
                                   indices_are_sorted=False)

    # chunk so the gathered intermediate + one-hot + partials stay ~1GB
    # (r5: the single-shot path materialized (B*T, n) — 8.6GB at 1M rows,
    # OOMing merge and the rbh residual on the giant grid row)
    chunk = max(1, int(_CHUNK_BYTES // max(T * n * 4, 1)) * 4)
    if B <= chunk:
        y = block_y(cols, vals, local_rows, out_rows, B)
    else:
        nc = -(-B // chunk)
        pad = nc * chunk - B
        if pad:
            cols = jnp.pad(cols, ((0, pad), (0, 0)))
            vals = jnp.pad(vals, ((0, pad), (0, 0)))
            local_rows = jnp.pad(local_rows, ((0, pad), (0, 0)))
            # pad blocks scatter into the sacrificial segment m
            out_rows = jnp.concatenate(
                [out_rows, jnp.full(pad * ROWS_CAP, m, jnp.int32)])

        def step(carry, blk):
            cb, vb, lb, ob = blk
            return carry + block_y(cb, vb, lb, ob, chunk), 0

        y, _ = jax.lax.scan(
            step, jnp.zeros((m + 1, n), acc),
            (cols.reshape(nc, chunk, T), vals.reshape(nc, chunk, T),
             local_rows.reshape(nc, chunk, T),
             out_rows.reshape(nc, chunk * ROWS_CAP)))
    return y[:m].astype(x.dtype)


def merge_spmm(a: DeviceMerge, x: jax.Array) -> jax.Array:
    """Y = A @ X with perfect nnz balance (see module doc)."""
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    y = _merge_spmm(a.cols, a.values, a.local_rows, a.out_rows, x2,
                    m=a.shape[0])
    return y[:, 0] if squeeze else y
