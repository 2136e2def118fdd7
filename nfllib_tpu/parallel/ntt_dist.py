"""Distributed four-step negacyclic NTT over a device mesh.

The reference scales only by SIMD width; its two inherent parallel axes — the
independent residue-channel (`cm`) loops and SIMD lanes inside a butterfly
(reference core.hpp:597,610, SURVEY.md section 2 note) — become mesh axes
here, and large-degree transforms gain a third: the degree axis, split
four-step style (the structural analog of sequence parallelism):

  n = n1 * n2, data viewed as X[i1, i2] (i = i2 + n2*i1), sharded over columns
  i2 on mesh axis `deg`:
    1. pre-twist by phi^i                        (local, elementwise)
    2. size-n1 DFTs down each column, root w^n2  (local: column-sharded)
    3. twiddle by w^(k1*i2)                      (local, elementwise)
    4. all-to-all transpose                      (the only collective)
    5. size-n2 DFTs along each row, root w^n1    (local: row-sharded)
  out[k1, k2] = E[k1 + n1*k2] where E[k] = A(phi^(2k+1)) in natural order.

The single-chip Harvey path (ops/ntt.py) and this path agree exactly:
harvey_out[j] = E[bitrev_n(j)] (verified in tests).  Pointwise products and
the inverse transform consume the four-step layout directly, so no global
reordering is ever needed in a distributed pipeline.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ring import (Ring, _harvey_blocked, _np_mulmod_vec, _np_shoup_vec,
                    _powers_mod, _shoup_arr)
from ..utils import bitrev_indices, static_log2
from ..ops import modops
from ..ops.ntt import _ntt_core


# ---------------------------------------------------------------------------
# table construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FourStepPlan:
    ring: Ring
    n1: int
    n2: int


def _sub_tables(p: int, w_root: int, size: int, wbits: int, obj: bool):
    """Blocked Harvey twiddles (+shoup) for a size-`size` DFT with root w."""
    pows = _powers_mod(w_root, size, p, obj=obj)
    blocked = _harvey_blocked(pows, size)
    return blocked, _shoup_arr(blocked, p, wbits, obj)


class FourStepContext:
    """Per-(ring, n1, n2) constants for the four-step transform."""

    def __init__(self, plan: FourStepPlan):
        ring = plan.ring
        self.plan = plan
        n1, n2 = plan.n1, plan.n2
        n, m = ring.degree, ring.nmoduli
        assert n1 * n2 == n
        dt = ring.dtype
        wbits = ring.repr_bits
        obj = ring.limb == "u64"
        ctx = ring.context()

        self.p_col = ctx.p_col
        shape1 = (m, max(n1 - 1, 1))
        shape2 = (m, max(n2 - 1, 1))
        self.col_w = np.empty(shape1, dtype=dt)       # size-n1 tables
        self.col_ws = np.empty(shape1, dtype=dt)
        self.col_iw = np.empty(shape1, dtype=dt)
        self.col_iws = np.empty(shape1, dtype=dt)
        self.row_w = np.empty(shape2, dtype=dt)       # size-n2 tables
        self.row_ws = np.empty(shape2, dtype=dt)
        self.row_iw = np.empty(shape2, dtype=dt)
        self.row_iws = np.empty(shape2, dtype=dt)

        for cm in range(m):
            p = int(ring.moduli[cm])
            w = ctx.omega_int[cm]
            iw = pow(w, -1, p)
            w1, iw1 = pow(w, n2, p), pow(iw, n2, p)
            w2, iw2 = pow(w, n1, p), pow(iw, n1, p)
            self.col_w[cm], self.col_ws[cm] = [a.astype(dt) for a in
                                               _sub_tables(p, w1, n1, wbits, obj)]
            self.col_iw[cm], self.col_iws[cm] = [a.astype(dt) for a in
                                                 _sub_tables(p, iw1, n1, wbits, obj)]
            self.row_w[cm], self.row_ws[cm] = [a.astype(dt) for a in
                                               _sub_tables(p, w2, n2, wbits, obj)]
            self.row_iw[cm], self.row_iws[cm] = [a.astype(dt) for a in
                                                 _sub_tables(p, iw2, n2, wbits, obj)]

        # phi pre-twist and inverse un-twist reshaped to [m, n1, n2]
        self.phis = ctx.phis.reshape(m, n1, n2)
        self.shoupphis = ctx.shoupphis.reshape(m, n1, n2)
        self.ivp = ctx.invpoly_times_invphis.reshape(m, n1, n2)
        self.ivp_s = ctx.shoupinvpoly_times_invphis.reshape(m, n1, n2)

        self.rev1 = bitrev_indices(n1)
        self.rev2 = bitrev_indices(n2)

    # --- [m, n1, n2] elementwise twiddle tables, built LAZILY per family -
    # A pipeline direction reads only one of the two (value, shoup)
    # families below.

    @functools.cached_property
    def _t_it(self):
        """uint64 [m, n1, n2] w^(k1*i2) and w^(-k1*i2), built
        column-iteratively with vectorized exact modmuls."""
        ring = self.plan.ring
        n1, n2 = self.plan.n1, self.plan.n2
        m = ring.nmoduli
        obj = ring.limb == "u64"
        ctx = ring.context()
        t_all = np.empty((m, n1, n2), dtype=np.uint64)
        it_all = np.empty((m, n1, n2), dtype=np.uint64)
        for cm in range(m):
            p = int(ring.moduli[cm])
            w = ctx.omega_int[cm]
            iw = pow(w, -1, p)
            k1_u64 = np.asarray(_powers_mod(w, n1, p, obj=obj)
                                ).astype(np.uint64)
            ik1_u64 = np.asarray(_powers_mod(iw, n1, p, obj=obj)
                                 ).astype(np.uint64)
            t_all[cm, :, 0] = 1
            it_all[cm, :, 0] = 1
            for i2 in range(1, n2):
                t_all[cm, :, i2] = _np_mulmod_vec(
                    t_all[cm, :, i2 - 1], k1_u64, p)
                it_all[cm, :, i2] = _np_mulmod_vec(
                    it_all[cm, :, i2 - 1], ik1_u64, p)
        return t_all, it_all

    def _with_shoup(self, vals):
        """(values, shoup) pair in the ring dtype from uint64 canonical."""
        ring = self.plan.ring
        dt = ring.dtype
        wbits = ring.repr_bits
        s = np.empty(vals.shape, dtype=np.uint64)
        for cm in range(ring.nmoduli):
            p = int(ring.moduli[cm])
            s[cm] = _np_shoup_vec(vals[cm].reshape(-1), p,
                                  wbits).reshape(vals.shape[1:])
        return vals.astype(dt), s.astype(dt)

    @functools.cached_property
    def _plain_fwd(self):
        return self._with_shoup(self._t_it[0])

    @functools.cached_property
    def _plain_inv(self):
        return self._with_shoup(self._t_it[1])

    @property
    def twiddle(self):          # w^(k1*i2)
        return self._plain_fwd[0]

    @property
    def twiddle_s(self):
        return self._plain_fwd[1]

    @property
    def itwiddle(self):         # w^(-k1*i2)
        return self._plain_inv[0]

    @property
    def itwiddle_s(self):
        return self._plain_inv[1]


@functools.lru_cache(maxsize=None)
def get_four_step_context(ring: Ring, n1: int, n2: int) -> FourStepContext:
    if n1 < 2 or n2 < 2 or n1 * n2 != ring.degree:
        raise ValueError(
            f"four-step factors must each be >= 2 and multiply to the "
            f"degree: n1={n1}, n2={n2}, degree={ring.degree} (a degenerate "
            f"factor means there is nothing to shard — use the single-chip "
            f"dispatch)")
    return FourStepContext(FourStepPlan(ring, n1, n2))


# ---------------------------------------------------------------------------
# local building blocks (run inside shard_map per device)
# ---------------------------------------------------------------------------

def _dft_lastaxis(x, blocked, blocked_s, size, p_col, rev):
    """Forward size-`size` DFT along the last axis of [..., m, B, size],
    natural output order (Harvey core + bitrev gather)."""
    if size == 1:
        return x
    ctx_tabs = []
    off = 0
    k = size
    while k >= 2:
        ctx_tabs.append((off, k // 2))
        off += k // 2
        k //= 2
    wt = [blocked[:, o:o + l] for o, l in ctx_tabs]
    ws = [blocked_s[:, o:o + l] for o, l in ctx_tabs]
    two_p = (p_col * 2).astype(x.dtype)
    # _ntt_core wants [..., m, n]: fold the B axis into batch by moving m next
    # to the transform axis.  x: [..., m, B, size] -> [..., B, m, size]
    xt = jnp.swapaxes(x, -3, -2)
    out = _ntt_core(xt, wt, ws, jnp.asarray(p_col), jnp.asarray(two_p))
    out = modops.reduce_once(out, jnp.asarray(p_col))
    out = jnp.take(out, jnp.asarray(rev), axis=-1)
    return jnp.swapaxes(out, -3, -2)


# ---------------------------------------------------------------------------
# distributed transforms
# ---------------------------------------------------------------------------

def _ppermute_transpose(x, tw, tws, p3, axis_name, d, fwd):
    """Twiddle + transpose expressed as d-1 point-to-point ppermutes (plus
    the local block) instead of one all-to-all.

    Each step s twiddles the block destined for device (me + s) and sends
    it one hop; step s+1's twiddle has no data dependence on step s's
    transfer, so a scheduler with asynchronous collective-permutes can
    overlap them.  Total comm volume equals the all-to-all's.

    fwd=True: x [.., m, n1, n2/d] column shard -> [.., m, n1/d, n2] row
    shard (split axis -2, concat axis -1); fwd=False mirrors it.  Output
    is bit-identical to jax.lax.all_to_all(tiled=True) on the same
    operands: the block received from source j lands at slot j of the
    concat axis."""
    split_ax, concat_ax = (-2, -1) if fwd else (-1, -2)
    nsplit = x.shape[split_ax]
    s_blk = nsplit // d
    me = jax.lax.axis_index(axis_name).astype(jnp.int32)
    d32 = jnp.int32(d)

    def blk_at(arr, t):
        return jax.lax.dynamic_slice_in_dim(arr, t * s_blk, s_blk,
                                            axis=split_ax)

    out_shape = list(x.shape)
    out_shape[split_ax] = s_blk
    out_shape[concat_ax] = x.shape[concat_ax] * d
    out = jnp.zeros(tuple(out_shape), x.dtype)
    for s in range(d):
        t = jax.lax.rem(me + jnp.int32(s), d32)  # this block's destination
        blk = modops.mulmod_shoup(blk_at(x, t), blk_at(tw, t),
                                  blk_at(tws, t), p3)
        if s:
            blk = jax.lax.ppermute(blk, axis_name,
                                   [(j, (j + s) % d) for j in range(d)])
        src = jax.lax.rem(me - jnp.int32(s) + d32, d32)  # block's sender
        out = jax.lax.dynamic_update_slice_in_dim(
            out, blk, src * x.shape[concat_ax], axis=concat_ax)
    return out


def _chunked_transpose(x, tw, tws, p3, axis_name, d, chunks, fwd):
    """Twiddle + all-to-all in `chunks` independent pieces along the split
    axis: each chunk is the c-th sub-block of every device-destination
    block, so concatenating the chunk outputs reproduces the monolithic
    transpose exactly, and the all-to-all of chunk c can overlap the
    twiddle of chunk c+1.  Axes as in _ppermute_transpose."""
    split_ax, concat_ax = (x.ndim - 2, x.ndim - 1) if fwd \
        else (x.ndim - 1, x.ndim - 2)
    s = x.shape[split_ax] // d // chunks

    def chunk(arr, c):
        # [.., d*chunks*s, ..] on the split axis -> the c-th s-rows of
        # every one of the d destination blocks
        ax = split_ax - (x.ndim - arr.ndim)
        shp = arr.shape
        v = arr.reshape(shp[:ax] + (d, chunks, s) + shp[ax + 1:])
        v = jax.lax.index_in_dim(v, c, axis=ax + 1, keepdims=False)
        return v.reshape(shp[:ax] + (d * s,) + shp[ax + 1:])

    outs = []
    for c in range(chunks):
        xc = modops.mulmod_shoup(chunk(x, c), chunk(tw, c), chunk(tws, c),
                                 p3)
        outs.append(jax.lax.all_to_all(xc, axis_name, split_axis=split_ax,
                                       concat_axis=concat_ax, tiled=True))
    return jnp.concatenate(outs, axis=split_ax)


def _transpose(x, tw, tws, p3, axis_name, d, chunks, transpose, fwd):
    """Steps 3+4 (twiddle, then columns <-> rows over `axis_name`); with
    no axis, the twiddle alone."""
    if axis_name is None:
        return modops.mulmod_shoup(x, tw, tws, p3)
    if transpose == "ppermute":
        assert chunks == 1, "ppermute already pipelines per block"
        return _ppermute_transpose(x, tw, tws, p3, axis_name, d, fwd)
    if chunks > 1:
        return _chunked_transpose(x, tw, tws, p3, axis_name, d, chunks, fwd)
    x = modops.mulmod_shoup(x, tw, tws, p3)
    split_ax, concat_ax = (x.ndim - 2, x.ndim - 1) if fwd \
        else (x.ndim - 1, x.ndim - 2)
    return jax.lax.all_to_all(x, axis_name, split_axis=split_ax,
                              concat_axis=concat_ax, tiled=True)


def four_step_ntt_local(x, fctx: FourStepContext, axis_name=None,
                        n_devices=1, chunks=1, transpose="a2a"):
    """Forward four-step pass.  x: [.., m, n1, n2_local] (column shard when
    axis_name is set, else the full [.., m, n1, n2]); `fctx`'s [m, n1, n2]
    tables are the same shard.  Returns [.., m, n1_local, n2] row shard (or
    the full array single-device).

    chunks > 1 splits the twiddle + all-to-all into `chunks` independent
    pieces (_chunked_transpose), so the collective of one chunk can overlap
    the twiddle of the next."""
    p3 = jnp.asarray(fctx.p_col)[..., None]            # [m,1,1]
    n1, n2 = fctx.plan.n1, fctx.plan.n2
    # 1. pre-twist by phi^i
    x = modops.mulmod_shoup(x, jnp.asarray(fctx.phis),
                            jnp.asarray(fctx.shoupphis), p3)
    # 2. size-n1 DFT down columns: transform axis is n1 (axis -2)
    xt = jnp.swapaxes(x, -1, -2)                       # [.., m, n2l, n1]
    xt = _dft_lastaxis(xt, jnp.asarray(fctx.col_w), jnp.asarray(fctx.col_ws),
                       n1, fctx.p_col, fctx.rev1)
    x = jnp.swapaxes(xt, -1, -2)                       # [.., m, n1, n2l]
    # 3+4. twiddle w^(k1*i2), then columns shard -> rows shard
    x = _transpose(x, jnp.asarray(fctx.twiddle), jnp.asarray(fctx.twiddle_s),
                   p3, axis_name, n_devices, chunks, transpose, fwd=True)
    # 5. size-n2 DFT along rows
    return _dft_lastaxis(x, jnp.asarray(fctx.row_w), jnp.asarray(fctx.row_ws),
                         n2, fctx.p_col, fctx.rev2)


def four_step_intt_local(x, fctx: FourStepContext, axis_name=None,
                         n_devices=1, chunks=1, transpose="a2a"):
    """Inverse of four_step_ntt_local.  x: [.., m, n1_local, n2] row shard
    -> [.., m, n1, n2_local] column shard of the coefficient tensor,
    un-twisted by n^-1 phi^-i.  chunks > 1 mirrors the forward pass."""
    p3 = jnp.asarray(fctx.p_col)[..., None]
    n1, n2 = fctx.plan.n1, fctx.plan.n2
    # inverse of step 5: unscaled inverse DFT along rows
    x = _dft_lastaxis(x, jnp.asarray(fctx.row_iw), jnp.asarray(fctx.row_iws),
                      n2, fctx.p_col, fctx.rev2)
    # inverse twiddle, then rows shard -> columns shard
    x = _transpose(x, jnp.asarray(fctx.itwiddle),
                   jnp.asarray(fctx.itwiddle_s), p3, axis_name, n_devices,
                   chunks, transpose, fwd=False)
    # inverse of step 2: inverse DFT down columns
    xt = jnp.swapaxes(x, -1, -2)
    xt = _dft_lastaxis(xt, jnp.asarray(fctx.col_iw),
                       jnp.asarray(fctx.col_iws), n1, fctx.p_col, fctx.rev1)
    x = jnp.swapaxes(xt, -1, -2)
    # un-twist by n^-1 * phi^-i (includes both 1/n1 and 1/n2)
    return modops.mulmod_shoup(x, jnp.asarray(fctx.ivp),
                               jnp.asarray(fctx.ivp_s), p3)


# ---------------------------------------------------------------------------
# mesh-level API
# ---------------------------------------------------------------------------

class _TableView:
    """FourStepContext facade whose elementwise tables are the per-device
    shards delivered as shard_map arguments (sharded by construction at
    device_put).  Sub-DFT tables stay small trace-time constants."""

    def __init__(self, fctx: FourStepContext, **tables):
        self.plan = fctx.plan
        self.p_col = fctx.p_col
        self.col_w, self.col_ws = fctx.col_w, fctx.col_ws
        self.col_iw, self.col_iws = fctx.col_iw, fctx.col_iws
        self.row_w, self.row_ws = fctx.row_w, fctx.row_ws
        self.row_iw, self.row_iws = fctx.row_iw, fctx.row_iws
        self.rev1, self.rev2 = fctx.rev1, fctx.rev2
        for k, v in tables.items():
            setattr(self, k, v)


# The transpose `transpose="auto"` selects.  On four NVLink-connected H100s
# (deg-sharded u64 n=2^20) this one was faster; see PERF.md.
_AUTO_TRANSPOSE = "a2a"


def _resolve_transpose(transpose: str, chunks: int = 1) -> str:
    """'auto' -> the measured default (_AUTO_TRANSPOSE), or 'a2a' when
    chunks > 1 (ppermute already pipelines per block).  Explicit 'a2a' /
    'ppermute' pass through; anything else is rejected."""
    if transpose not in ("auto", "a2a", "ppermute"):
        raise ValueError(f"transpose must be auto|a2a|ppermute, "
                         f"got {transpose!r}")
    if transpose != "auto":
        return transpose
    return "a2a" if chunks > 1 else _AUTO_TRANSPOSE


_FWD_TABLES = ("phis", "shoupphis", "twiddle", "twiddle_s")
_INV_TABLES = ("itwiddle", "itwiddle_s", "ivp", "ivp_s")


def _sharded_tables(fctx, mesh, deg_axis, names, specs):
    """device_put each [m, n1, n2] table with its spec, once per build.
    Eager even under an outer jit trace: the _build_* functions are
    lru-cached, and a traced device_put would cache tracers
    (UnexpectedTracerError later)."""
    with jax.ensure_compile_time_eval():
        return tuple(jax.device_put(np.asarray(getattr(fctx, k)),
                                    NamedSharding(mesh, sp))
                     for k, sp in zip(names, specs))


@functools.lru_cache(maxsize=None)
def _build_dist_fwd(ring: Ring, mesh: Mesh, n1: int, deg_axis: str,
                    ndim: int, chunks: int = 1, transpose: str = "a2a"):
    """Cached jitted forward transform (one compile per shape family).  The
    phi twist and twiddle tables are column-sharded like the data, so each
    device holds 1/D of them and no gather appears in the program."""
    fctx = get_four_step_context(ring, n1, ring.degree // n1)
    tspec = P(None, None, deg_axis)
    tabs = _sharded_tables(fctx, mesh, deg_axis, _FWD_TABLES,
                           (tspec,) * len(_FWD_TABLES))
    d = mesh.shape[deg_axis]

    def local(xb, *shards):
        view = _TableView(fctx, **dict(zip(_FWD_TABLES, shards)))
        return four_step_ntt_local(xb, view, axis_name=deg_axis,
                                   n_devices=d, chunks=chunks,
                                   transpose=transpose)

    spec = P(*([None] * (ndim - 1) + [deg_axis]))
    out_spec = P(*([None] * (ndim - 2) + [deg_axis, None]))
    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(spec,) + (tspec,) * len(tabs),
                           out_specs=out_spec, check_vma=False))
    return lambda x: fn(x, *tabs)


def _split_factors(ring: Ring, mesh: Mesh, deg_axis: str, n1):
    n = ring.degree
    if n1 is None:
        n1 = 1 << (static_log2(n) // 2)
    d = mesh.shape[deg_axis]
    assert n1 % d == 0 and (n // n1) % d == 0, \
        "factor sizes must split evenly"
    return n1, n // n1, d


def distributed_ntt_pow_phi(x, ring: Ring, mesh: Mesh, *, n1=None,
                            deg_axis: str = "deg", chunks: int = 1,
                            transpose: str = "auto"):
    """Forward negacyclic transform of [..., m, n] sharded over `deg_axis`.

    Returns the four-step layout [..., m, n1, n2] with rows (k1) sharded.
    E[k1 + n1*k2] = out[..., k1, k2]; the single-chip Harvey ordering is
    harvey[j] = E[bitrev_n(j)].

    transpose: 'auto' (see _resolve_transpose), or an explicit
    'a2a'/'ppermute'.
    """
    transpose = _resolve_transpose(transpose, chunks)
    n1, n2, d = _split_factors(ring, mesh, deg_axis, n1)
    if chunks > 1:
        assert n1 % (d * chunks) == 0, "chunks must divide the row blocks"
    xr = x.reshape(x.shape[:-1] + (n1, n2))
    return _build_dist_fwd(ring, mesh, n1, deg_axis, xr.ndim, chunks,
                           transpose)(xr)


@functools.lru_cache(maxsize=None)
def _build_dist_fwd_pipelined(ring: Ring, mesh: Mesh, n1: int,
                              deg_axis: str, nbatch: int,
                              transpose: str = "ppermute"):
    """THROUGHPUT-MODE builder: `nbatch` independent transforms in ONE
    jitted program, the batch loop UNROLLED inside shard_map, so that a
    scheduler with asynchronous collectives can overlap transform b's
    transpose hops with transform b+1's local compute.  Output is
    bit-identical to running distributed_ntt_pow_phi per batch element
    (tests/test_parallel.py)."""
    fctx = get_four_step_context(ring, n1, ring.degree // n1)
    tspec = P(None, None, deg_axis)
    tabs = _sharded_tables(fctx, mesh, deg_axis, _FWD_TABLES,
                           (tspec,) * len(_FWD_TABLES))
    d = mesh.shape[deg_axis]

    def local(xb, *shards):
        view = _TableView(fctx, **dict(zip(_FWD_TABLES, shards)))
        outs = [four_step_ntt_local(xb[b], view, axis_name=deg_axis,
                                    n_devices=d, transpose=transpose)
                for b in range(nbatch)]
        return jnp.stack(outs)

    spec = P(None, None, None, deg_axis)
    out_spec = P(None, None, deg_axis, None)
    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(spec,) + (tspec,) * len(tabs),
                           out_specs=out_spec, check_vma=False))
    return lambda x: fn(x, *tabs)


def distributed_ntt_pow_phi_pipelined(x, ring: Ring, mesh: Mesh, *,
                                      n1=None, deg_axis: str = "deg",
                                      transpose: str = "ppermute"):
    """Batch-pipelined forward transform of [B, m, n] (B independent
    polynomials): one jitted program whose unrolled batch loop lets XLA
    overlap transform b's transpose collectives with transform b+1's
    compute.  Returns [B, m, n1, n2] row-sharded four-step layout,
    bit-identical per element to distributed_ntt_pow_phi."""
    transpose = _resolve_transpose(transpose)
    assert x.ndim == 3, "expected [B, m, n]"
    n1, n2, _ = _split_factors(ring, mesh, deg_axis, n1)
    xr = x.reshape(x.shape[:-1] + (n1, n2))
    return _build_dist_fwd_pipelined(ring, mesh, n1, deg_axis, x.shape[0],
                                     transpose)(xr)


@functools.lru_cache(maxsize=None)
def _build_dist_inv(ring: Ring, mesh: Mesh, n1: int, deg_axis: str,
                    ndim: int, chunks: int = 1, transpose: str = "a2a"):
    fctx = get_four_step_context(ring, n1, ring.degree // n1)
    rspec = P(None, deg_axis, None)
    cspec = P(None, None, deg_axis)
    specs = (rspec, rspec, cspec, cspec)
    tabs = _sharded_tables(fctx, mesh, deg_axis, _INV_TABLES, specs)
    d = mesh.shape[deg_axis]

    def local(yb, *shards):
        view = _TableView(fctx, **dict(zip(_INV_TABLES, shards)))
        return four_step_intt_local(yb, view, axis_name=deg_axis,
                                    n_devices=d, chunks=chunks,
                                    transpose=transpose)

    spec = P(*([None] * (ndim - 2) + [deg_axis, None]))
    out_spec = P(*([None] * (ndim - 2) + [None, deg_axis]))
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,) + specs,
                           out_specs=out_spec, check_vma=False))
    return lambda y: fn(y, *tabs)


def distributed_invntt_pow_invphi(y, ring: Ring, mesh: Mesh, *, n1=None,
                                  deg_axis: str = "deg", chunks: int = 1,
                                  transpose: str = "auto"):
    """Inverse of distributed_ntt_pow_phi: [..., m, n1(sharded), n2] four-step
    layout -> coefficient tensor [..., m, n] sharded over the degree axis."""
    transpose = _resolve_transpose(transpose, chunks)
    n1, n2, d = _split_factors(ring, mesh, deg_axis, n1)
    if chunks > 1:
        assert n2 % (d * chunks) == 0, "chunks must divide the column blocks"
    out = _build_dist_inv(ring, mesh, n1, deg_axis, y.ndim, chunks,
                          transpose)(y)
    return out.reshape(out.shape[:-2] + (ring.degree,))


def four_step_reference(x, ring: Ring, n1: int):
    """Single-device four-step forward (no mesh) — for differential tests."""
    fctx = get_four_step_context(ring, n1, ring.degree // n1)
    xr = jnp.asarray(x).reshape(x.shape[:-1] + (n1, ring.degree // n1))
    return four_step_ntt_local(xr, fctx)


def four_step_reference_inverse(y, ring: Ring, n1: int):
    fctx = get_four_step_context(ring, n1, ring.degree // n1)
    xb = four_step_intt_local(jnp.asarray(y), fctx)
    return xb.reshape(xb.shape[:-2] + (ring.degree,))
