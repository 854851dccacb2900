"""GELL: gather-based ELL SpMM — the hypersparse workhorse kernel.

Re-designs the reference's inspector-executor CSR SpMM for the regime the
reference runs MKL IE in (spmm_kernel_mkl_ie.cpp:75-104: 5-100 nnz/row,
m = 65k-2M, n = 512, where EPYC MKL-IE lands 105-328 GFLOPS), and doubles
as the SELL-C-sigma SpMM the reference benchmarks standalone
(spmv_code_sell-C-s/spmvbench/spmvbench.c:1-303).

Design:

- The irreducible primitive is a random gather of ~2KB X rows (n = 512
  f32) from device memory.
- ELL (fixed slots/row) instead of COO+segment-sum: the slot sum is a
  dense reduction XLA fuses, with no scatter.  Skewed rows overflow into
  a small COO tail handled by segment_sum.
- Rows are processed in chunks so the gathered intermediate stays bounded
  for m up to millions.
- **Windowed gathering**: the gather rate falls once the source outgrows
  the last-level cache (on the H100, 938 Mrow/s from a 16 MB source vs
  678 Mrow/s from 1 GiB — the `gather_fast`/`gather_slow` probes of
  `chip_smoke.py --calibrate`).  For column-local (banded) matrices, rows
  are processed in uniform chunks whose X window (a dynamic slice
  precomputed at format build) stays under a fixed source size, and a
  lax.scan drives per-chunk take+combine with host-precomputed
  window-local indices.  The window size and the split modes below were
  tuned on an earlier accelerator and are not re-measured on the H100
  (PERF.md, Open questions).

Modes: "f32" (default: exact, windowed when the structure allows),
"bf16" (CV-on-X mode — half gather bytes, windowed, gated against the
bf16 X it gathers; ref value-compression study lib/bitstream.c),
"split24"/"split16" (bf16 plane splits of X — ``[bf16(x) | bf16(x -
f32(bf16(x)))]``, reconstructed as ``hi + lo`` — with a block-diagonal
matmul slot contraction; halves the gathered source bytes; split24 is
f32-oracle-exact).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from spgrid.formats.csr import CSRMatrix


@jax.tree_util.register_pytree_node_class
class DeviceGELL:
    """ELL slots (m_pad, S) + COO overflow tail, device-resident.

    Slot width S defaults to ceil(1.25 * avg_nnz_per_row) rounded up so
    >= ~90% of nnz land in slots for mild skew; the rest stream through
    the COO tail (rows sorted, segment-sum).
    """

    def tree_flatten(self):
        return ((self.cols, self.values, self.tail_rows, self.tail_cols,
                 self.tail_vals, self.win_cols, self.win_vals,
                 self.win_bases),
                (self.shape, self.nnz, self.slots, self.mode, self.name,
                 self.win_plan))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.cols, obj.values, obj.tail_rows, obj.tail_cols,
         obj.tail_vals, obj.win_cols, obj.win_vals, obj.win_bases) = children
        (obj.shape, obj.nnz, obj.slots, obj.mode, obj.name,
         obj.win_plan) = aux
        return obj

    def __init__(self, csr: CSRMatrix, slots: int | None = None,
                 mode: str = "f32"):
        m, k = csr.shape
        deg = csr.degrees
        if slots is None:
            avg = csr.nnz / max(m, 1)
            slots = max(1, int(np.ceil(avg * 1.25)))
            # don't let mild skew force a tail when a slightly wider ELL
            # would hold everything
            if deg.size and int(deg.max()) <= slots + 2:
                slots = int(deg.max())
        slots = max(1, slots)
        m_pad = -(-max(m, 1) // 8) * 8

        cols = np.zeros((m_pad, slots), dtype=np.int32)  # pad: row 0, val 0
        vals = np.zeros((m_pad, slots), dtype=np.float32)
        # slot assignment: first `slots` nnz of each row
        nnz_idx = np.arange(csr.nnz, dtype=np.int64)
        row_of = np.repeat(np.arange(m, dtype=np.int64), deg)
        within = nnz_idx - np.repeat(csr.row_ptr[:-1].astype(np.int64), deg)
        take_mask = within < slots
        cols[row_of[take_mask], within[take_mask]] = \
            csr.col_idx[take_mask].astype(np.int32)
        vals[row_of[take_mask], within[take_mask]] = csr.values[take_mask]
        tail = ~take_mask
        self.cols = jnp.asarray(cols)
        self.values = jnp.asarray(vals)
        self.tail_rows = jnp.asarray(row_of[tail].astype(np.int32))
        self.tail_cols = jnp.asarray(csr.col_idx[tail].astype(np.int32))
        self.tail_vals = jnp.asarray(csr.values[tail].astype(np.float32))
        self.shape = csr.shape
        self.nnz = csr.nnz
        self.slots = slots
        self.mode = mode
        self.name = csr.name
        self._plan_windows(cols, vals, k)

    def _plan_windows(self, cols, vals, k):
        """Precompute the windowed-gather plan (see module doc: the XLA
        row gather runs ~4-5x faster when its source is < ~64MB, so for
        column-local (banded) matrices each row-chunk gathers from a
        dynamic slice of X instead of the full array).

        The cap is SOURCE BYTES, so it is mode-dependent (r3): bf16 rows
        are half the f32/split16 bytes, doubling the windowable band
        width (~61k rows at n=512) — CV-on-X mode reaches bands the exact
        modes cannot.  Planned at the documented n=512; the kernel
        re-checks the bytes at its actual n and falls back if wider."""
        row_bytes = {"f32": 4, "bf16": 2, "split16": 4,
                     "split24": 4}.get(self.mode, 4) * 512
        SPAN_CAP = ((63 << 20) // row_bytes) // 1024 * 1024
                                            # rows: <=63MB window at n=512
                                            # (gather fast path needs the
                                            # source under ~64MB; the
                                            # kernel re-checks at its n)
        m_pad, S = cols.shape
        self.win_plan = None
        empty = jnp.zeros((0,), jnp.int32)
        self.win_cols = self.win_vals = self.win_bases = empty
        if k <= SPAN_CAP:
            return                          # source already small: direct
        real = vals != 0
        for rb in (16384, 8192, 4096, 2048, 1024):
            if rb > m_pad and rb != 16384:
                continue
            rbe = min(rb, -(-m_pad // 8) * 8)
            nb = -(-m_pad // rbe)
            pad = nb * rbe - m_pad
            cp = np.pad(cols, ((0, pad), (0, 0)))
            vp = np.pad(vals, ((0, pad), (0, 0)))
            rp = np.pad(real, ((0, pad), (0, 0)))
            c3 = cp.reshape(nb, rbe * S)
            r3 = rp.reshape(nb, rbe * S)
            minc = np.where(r3, c3, k).min(axis=1)
            maxc = np.where(r3, c3, -1).max(axis=1)
            minc = np.minimum(minc, np.maximum(maxc, 0))
            span_req = int((maxc - minc + 1).max(initial=1))
            if span_req <= SPAN_CAP:
                span = min(k, SPAN_CAP)
                bases = np.clip(minc, 0, k - span).astype(np.int32)
                local = np.clip(c3.reshape(nb, rbe, S)
                                - bases[:, None, None], 0, span - 1)
                self.win_plan = (nb, rbe, span)
                self.win_cols = jnp.asarray(local.astype(np.int32))
                self.win_vals = jnp.asarray(vp.reshape(nb, rbe, S))
                self.win_bases = jnp.asarray(bases)
                return

    @classmethod
    def from_csr(cls, csr: CSRMatrix, slots: int | None = None,
                 mode: str = "f32") -> "DeviceGELL":
        return cls(csr, slots=slots, mode=mode)

    @property
    def mem_footprint(self) -> int:
        base = (self.cols.size * 4 + self.values.size * 4
                + self.tail_rows.size * 12)
        if self.win_plan is not None:
            base += self.win_cols.size * 8 + self.win_bases.size * 4
        return base


def _trunc_bf16(x: jax.Array) -> jax.Array:
    """Truncate f32 to a bf16-representable f32 by mantissa masking.

    Bit-level (not a convert pair) on purpose: the platform compiles with
    --xla_allow_excess_precision=true, which folds f32->bf16->f32 round
    trips to the identity and silently voids a convert-based split
    (observed: split modes degraded to plain-bf16 error).  An integer AND
    cannot be folded.
    """
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    return jax.lax.bitcast_convert_type(u & jnp.uint32(0xFFFF0000),
                                        jnp.float32)


def _split_planes(x: jax.Array, nplanes: int) -> tuple:
    """(k, n) f32 -> `nplanes` bf16 planes whose sum reconstructs x.

    Truncation split: plane p holds the next 8 mantissa bits.  3 planes
    cover the full 24-bit f32 mantissa => hi+mid+lo == x EXACTLY, so the
    kernel is f32-oracle-exact while every gather moves 16-bit elements.
    Planes stay separate (k, n) arrays: gathers of non-power-of-2-width
    concatenated rows can fall off XLA's fast gather path.
    """
    planes = []
    r = x
    for _ in range(nplanes - 1):
        p = _trunc_bf16(r)
        planes.append(p.astype(jnp.bfloat16))
        r = r - p                 # exact (aligned operands)
    planes.append(r.astype(jnp.bfloat16))
    return tuple(planes)


# gathered bf16-equivalents per slot (f32 = 2 bf16 units of bytes)
_PLANES = {"split16": 2, "split24": 3, "bf16": 1, "f32": 2}


_CHUNK_BUDGET = 3 << 30     # bytes of gathered intermediate per chunk
_PER_WIN_CONVERT_BUDGET = 6 << 30   # resident bytes above which the
                                    # windowed bf16/split16 paths convert
                                    # per window slice instead of
                                    # materializing a full derived source


def _chunk_rows(m_pad: int, slots: int, n: int, mode: str,
                budget: int | None = None) -> int:
    """Row-chunk size keeping the gathered intermediate under `budget` B.

    Each extra chunk costs a loop step, so the budget is generous: chunk
    only when the gathered intermediate would strain device memory.
    """
    if budget is None:
        budget = _CHUNK_BUDGET
    per_row = max(slots * _PLANES[mode] * n * 2, 1)
    rows = max(budget // per_row, 8)
    rows = min(rows, m_pad)
    return -(-rows // 8) * 8


def _blockdiag_A(v: jax.Array) -> jax.Array:
    """(rb, S) values -> (rb/8, 8, 8S) bf16 block-diagonal slot matrix.

    Row r of an 8-row block multiplies only its own S gathered rows; the
    slot contraction runs as a batched (8, 8S) @ (8S, n) bf16 matmul,
    whose ~8x zero-padding flops are cheap next to the multi-stream
    convert+mul+reduce alternative.
    """
    rb, S = v.shape
    eye = jnp.eye(8, dtype=v.dtype)
    a = jnp.einsum("pq,bps->bpqs", eye, v.reshape(rb // 8, 8, S))
    return a.reshape(rb // 8, 8, 8 * S)


def _mxu_combine(a_planes, b, nb8, S, n_out, precision=None):
    """sum_p einsum('brc,bcn->brn', A_p, B) -> (rows, n_out) f32."""
    out = None
    for ap in a_planes:
        o = jax.lax.dot_general(
            ap, b, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32, precision=precision)
        out = o if out is None else out + o
    return out.reshape(nb8 * 8, n_out)


# windowed-f32 combine engine: "mxu" (f32 block-diagonal dot at HIGHEST,
# reads the gathered intermediate at streaming rate) or "vpu" (broadcast
# mul + slot-axis reduce).  A static jit arg either way; the env override
# selects the engine for an A/B without a code change.
WIN_F32_COMBINE = os.environ.get("SPGRID_GELL_F32_COMBINE", "mxu")


@functools.partial(jax.jit,
                   static_argnames=("m", "mode", "win_plan", "f32_combine"))
def _gell_spmm(cols, vals, trows, tcols, tvals, wcols, wvals, wbases, x, *,
               m, mode, win_plan, f32_combine="mxu"):
    k, n = x.shape
    m_pad, S = cols.shape
    use_win = win_plan is not None and mode in ("f32", "bf16", "split16")
    if use_win:
        # the plan was sized for n=512 f32; re-check the window source
        # bytes at this n/mode against the 64MB window cap
        row_bytes = {"f32": 4 * n, "bf16": 2 * n, "split16": 4 * n}[mode]
        use_win = win_plan[2] * row_bytes <= (1 << 26)
        if mode == "split16":
            # the (k, 2n) [hi|lo] source only keeps XLA's fast gather
            # path when 2n is a power of two (_split_planes doc): at
            # e.g. n=384 the windowed gather would take the ~5x slow
            # path it exists to avoid — fall back to the direct path
            use_win = use_win and (n & (n - 1)) == 0
    if use_win:
        nb, rbw, span = win_plan
        # adaptive source materialization: the derived bf16/[hi|lo]
        # source is a full-size copy next to X; at giant m the residents
        # (X + stacked scan output + y) already claim most of device
        # memory.  Above the budget, slice the f32 X per
        # window block and convert the slice instead — no full-size copy,
        # same math (the plane split is elementwise).
        resident = x.size * x.dtype.itemsize + m_pad * n * 8
        per_win_convert = mode in ("bf16", "split16") \
            and resident + x.size * 2 * _PLANES[mode] \
            > _PER_WIN_CONVERT_BUDGET
        if mode == "f32" or per_win_convert:
            src = x
        elif mode == "bf16":
            src = x.astype(jnp.bfloat16)
        else:
            # split16: one (k, 2n) [hi|lo] bf16 source — the SAME source
            # bytes (and 2n stays a power of 2 at n=512, keeping the fast
            # gather path) but the combine becomes a block-diagonal bf16
            # matmul that streams the gathered rows with negligible flop
            # cost
            hi, lo = _split_planes(x, 2)
            src = jnp.concatenate([hi, lo], axis=1)
        w = n if mode in ("f32", "bf16") else 2 * n

        def body(_, blk):
            cl, vl, base = blk
            if per_win_convert:
                xf = jax.lax.dynamic_slice(x, (base, 0), (span, n))
                if mode == "bf16":
                    xw = xf.astype(jnp.bfloat16)
                else:
                    hi, lo = _split_planes(xf, 2)
                    xw = jnp.concatenate([hi, lo], axis=1)
            else:
                xw = jax.lax.dynamic_slice(src, (base, 0), (span, w))
            g = jnp.take(xw, cl.reshape(-1), axis=0)
            if mode in ("bf16", "split16"):
                # values split into 2 bf16 planes (8 mantissa bits each):
                # all four v x cross terms are kept, so the error floor is
                # the hi/lo X representation (~2^-17 rel), inside the f32
                # oracle gate (1e-4) for split16 and the bf16 gate for bf16
                a_planes = [_blockdiag_A(vp) for vp in _split_planes(vl, 2)]
                bmat = g.reshape(rbw // 8, 8 * S, w)
                o = _mxu_combine(a_planes, bmat, rbw // 8, S, w)
                y = (o[:, :n] + o[:, n:]) if w > n else o
            elif f32_combine == "mxu":
                # f32-exact matmul combine: one f32 block-diagonal matmul
                # at HIGHEST precision.  The gathered intermediate is
                # materialized by the take either way; the matmul streams
                # it back in one pass.  Flops are negligible (2*8*n per
                # slot-row).
                a = _blockdiag_A(vl)
                bmat = g.reshape(rbw // 8, 8 * S, n)
                y = _mxu_combine([a], bmat, rbw // 8, S, n,
                                 precision=jax.lax.Precision.HIGHEST)
            else:
                y = jnp.sum(vl[:, :, None]
                            * g.astype(jnp.float32).reshape(rbw, S, n),
                            axis=1)
            return 0, y

        _, ys = jax.lax.scan(body, 0, (wcols, wvals, wbases))
        y = ys.reshape(nb * rbw, n)[:m]
        if per_win_convert and trows.shape[0]:
            # tail rows: gather from f32 X then quantize, matching the
            # window path's representation (there is no full-size src)
            xt = jnp.take(x, tcols, axis=0)
            if mode == "bf16":
                tail_g = (xt.astype(jnp.bfloat16),)
            else:
                hi, lo = _split_planes(xt, 2)
                tail_g = (jnp.concatenate([hi, lo], axis=1),)
            ident = jnp.arange(xt.shape[0], dtype=jnp.int32)
            return _add_tail(y, trows, ident, tvals, tail_g, m, n) \
                .astype(x.dtype)
        return _add_tail(y, trows, tcols, tvals, (src,), m, n) \
            .astype(x.dtype)
    if mode == "split16":
        hi, lo = _split_planes(x, 2)
        planes = (jnp.concatenate([hi, lo], axis=1),)   # (k, 2n) [hi|lo]
    elif mode == "split24":
        hi, mid, lo = _split_planes(x, 3)
        planes = (jnp.concatenate([hi, mid], axis=1), lo)
    elif mode == "bf16":
        planes = (x.astype(jnp.bfloat16),)
    else:
        planes = (x,)

    # adaptive budget: at giant m the operands themselves (X + Y + the
    # scan-stacked output) already claim several GB of device memory;
    # shrink the gathered-intermediate budget by the resident operand bytes
    resident = 2 * x.size * x.dtype.itemsize + m_pad * n * 4
    rb = _chunk_rows(m_pad, S, n, mode,
                     budget=max(_CHUNK_BUDGET - resident, 1 << 28))
    nb = -(-m_pad // rb)
    if nb * rb != m_pad:
        pad = nb * rb - m_pad
        cols = jnp.pad(cols, ((0, pad), (0, 0)))
        vals = jnp.pad(vals, ((0, pad), (0, 0)))
    use_mxu = mode in ("split16", "split24", "bf16")

    def chunk_out(cb, vb):
        idxb = cb.reshape(-1)
        if use_mxu:
            # values split into bf16 planes too: every matmul product is an
            # exact bf16 x bf16 with f32 accumulation.  Term budget (v and
            # x planes each carry 8 mantissa bits/plane): split24 keeps
            # all cross terms down to 2^-24 of v*x and drops only vl*lo
            # (~2^-32) — f32-class; split16/bf16 keep v to 2^-16.
            nv = 3 if mode == "split24" else 2
            a_planes = [_blockdiag_A(vp)
                        for vp in _split_planes(vb, nv)]
            yb = None
            for p in planes:
                g = jnp.take(p, idxb, axis=0)          # (rb*S, w) bf16
                w = p.shape[1]
                bmat = g.reshape(rb // 8, 8 * S, w)
                ap = a_planes if w > n else a_planes[:2]
                o = _mxu_combine(ap, bmat, rb // 8, S, w)
                o32 = (o[:, :n] + o[:, n:]) if w > n else o
                yb = o32 if yb is None else yb + o32
            return yb
        g32 = sum(jnp.take(p, idxb, axis=0).astype(jnp.float32)
                  for p in planes).reshape(rb, S, n)
        # explicit mul+sum: full f32 on the VPU regardless of the
        # ambient matmul precision
        return jnp.sum(vb[:, :, None] * g32, axis=1)

    if nb == 1:
        y = chunk_out(cols, vals)
    else:
        # lax.scan, not an unrolled loop: unrolled chunks stack each
        # chunk's gather scratch into one allocation
        _, ys = jax.lax.scan(
            lambda c, blk: (0, chunk_out(*blk)), 0,
            (cols.reshape(nb, rb, S), vals.reshape(nb, rb, S)))
        y = ys.reshape(nb * rb, n)
    y = y[:m]
    return _add_tail(y, trows, tcols, tvals, planes, m, n).astype(x.dtype)


def _add_tail(y, trows, tcols, tvals, planes, m, n):
    if not trows.shape[0]:
        return y
    def _collapse(g):
        g = g.astype(jnp.float32)
        return g[:, :n] + g[:, n:] if g.shape[1] > n else g
    gt = sum(_collapse(jnp.take(p, tcols, axis=0)) for p in planes)
    # correctness barrier: a backend once miscompiled the scatter-add when
    # the summed multi-plane gathers fused into segment_sum's operand
    # (observed maxdiff ~5 vs host; bit-exact with the fusion cut here)
    gt = jax.lax.optimization_barrier(gt)
    prods = tvals[:, None] * gt
    return y + jax.ops.segment_sum(prods, trows, num_segments=m + 1,
                                   indices_are_sorted=True)[:m]


def gell_spmm(a: DeviceGELL, x: jax.Array) -> jax.Array:
    """Y = A @ X. x may be (k,) or (k, n)."""
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    y = _gell_spmm(a.cols, a.values, a.tail_rows, a.tail_cols, a.tail_vals,
                   a.win_cols, a.win_vals, a.win_bases,
                   x2, m=a.shape[0], mode=a.mode, win_plan=a.win_plan,
                   f32_combine=WIN_F32_COMBINE)
    return y[:, 0] if squeeze else y
