"""Negacyclic NTT / inverse NTT on residue tensors (jnp implementation).

Re-design of the reference NTT engine (reference
include/nfl/core.hpp:438-614, include/nfl/algos.hpp:16-73): the same Harvey
butterfly mathematics — lazy [0,2p) arithmetic, Shoup-precomputed twiddles,
blocked twiddle tables, bit-reversed forward-domain ordering — expressed as
whole-array stage transforms instead of scalar loops, left to XLA to compile
for the device; the residue-channel axis `m` and any batch axes are
embarrassingly parallel (the reference's `cm` loop, core.hpp:597,610).

Shapes: data is [..., m, n]; twiddle tables come from RingContext ([m, n-1]
blocked, [m, n] for the phi pre-twist).  Outputs of `ntt_pow_phi` are
bit-identical to the reference's (canonical residues, Harvey ordering).

A note on the last two butterfly layers: the reference hand-unrolls them
without twiddle multiplies (core.hpp:488-521).  Here all log2(n) stages use
the generic lazy-Shoup butterfly — the blocked tables contain the needed
w^0 = 1 entries, and after the final strict reduction the canonical outputs
are identical (multiplying by 1 lazily preserves the value mod p).
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import debug
from ..ring import RingContext
from ..utils import static_log2
from . import modops


def _stage_tables(ctx: RingContext):
    """Per-stage [m, n >> (s+1)] twiddle slices of the blocked tables."""
    wt, wi, iwt, iwi = [], [], [], []
    for off, length in ctx.stage_offsets:
        sl = slice(off, off + length)
        wt.append(ctx.omegas[:, sl])
        wi.append(ctx.shoupomegas[:, sl])
        iwt.append(ctx.invomegas[:, sl])
        iwi.append(ctx.shoupinvomegas[:, sl])
    return wt, wi, iwt, iwi


def _ntt_core(x, wtabs, witabs, p_col, two_p):
    """All-stages Harvey DIF butterfly pass; in: [..., m, n] < p, out: [0,2p).

    Stage s splits each length-(n>>s) segment in half:
      t0 = u0 + u1            (lazy mod 2p)
      t1 = u0 - u1 + 2p       (< 4p, wrapping dtype arithmetic)
      x1 = t1*w - (hi(t1*w') >> bits)*p   (Harvey lazy Shoup, < 2p)
    """
    batch = x.shape[:-2]
    m, n = x.shape[-2], x.shape[-1]
    stages = static_log2(n)
    for s in range(stages):
        half = n >> (s + 1)
        v = x.reshape(batch + (m, 1 << s, 2 * half))
        u0 = v[..., :half]
        u1 = v[..., half:]
        wt = jnp.asarray(wtabs[s])[:, None, :]
        wi = jnp.asarray(witabs[s])[:, None, :]
        p = p_col[:, None, :]
        t0 = u0 + u1
        t0 = t0 - jnp.where(t0 >= two_p[:, None, :], two_p[:, None, :],
                            jnp.zeros_like(t0))
        t1 = u0 - u1 + two_p[:, None, :]
        q = modops.mulhi(t1, wi)
        t2 = t1 * wt - q * p
        x = jnp.concatenate([t0, t2], axis=-1).reshape(batch + (m, n))
    return x


def ntt(x, ctx: RingContext, *, inverse_tables: bool = False):
    """One forward Harvey NTT pass over [..., m, n] (no phi twist, no
    permutation), with the reference's final strict reduction to [0, p)
    (NTT_STRICTMOD is always on: reference debug.hpp:31, core.hpp:523-529)."""
    ring = ctx.ring
    x = jnp.asarray(x)
    dt = x.dtype
    p_col = jnp.asarray(ctx.p_col)
    debug.check_residues(x, p_col)   # strict mode: inputs must be < p
    if ring.degree == 1:
        return x
    two_p = (p_col * 2).astype(dt)
    wt, wi, iwt, iwi = _stage_tables(ctx)
    if inverse_tables:
        wt, wi = iwt, iwi
    if ring.degree == 2:
        # special case (reference core.hpp:472-483)
        u0, u1 = x[..., :1], x[..., 1:]
        t0 = u0 + u1
        t0 = t0 - jnp.where(t0 >= two_p, two_p, jnp.zeros_like(t0))
        t1 = u0 - u1 + two_p
        t1 = t1 - jnp.where(t1 >= two_p, two_p, jnp.zeros_like(t1))
        out = jnp.concatenate([t0, t1], axis=-1)
        return modops.reduce_once(out, p_col)
    out = _ntt_core(x, wt, wi, p_col, two_p)
    return modops.reduce_once(out, p_col)


def inv_ntt(x, ctx: RingContext):
    """Bit-reverse -> forward pass with inverse twiddles -> bit-reverse
    (reference core.hpp:539-557).  No n^-1 scaling."""
    rev = jnp.asarray(ctx.bitrev)
    y = jnp.take(x, rev, axis=-1)
    y = ntt(y, ctx, inverse_tables=True)
    return jnp.take(y, rev, axis=-1)


def ntt_pow_phi(x, ctx: RingContext):
    """Negacyclic forward transform: fused shoup(x * phi^i) pre-twist then NTT
    (reference core.hpp:594-600)."""
    phis = jnp.asarray(ctx.phis)
    sphis = jnp.asarray(ctx.shoupphis)
    p_col = jnp.asarray(ctx.p_col)
    tw = modops.mulmod_shoup(jnp.asarray(x), phis, sphis, p_col)
    return ntt(tw, ctx)


def invntt_pow_invphi(x, ctx: RingContext):
    """Inverse transform with fused n^-1 * phi^-i un-twist
    (reference core.hpp:608-614)."""
    y = inv_ntt(jnp.asarray(x), ctx)
    itab = jnp.asarray(ctx.invpoly_times_invphis)
    sitab = jnp.asarray(ctx.shoupinvpoly_times_invphis)
    p_col = jnp.asarray(ctx.p_col)
    return modops.mulmod_shoup(y, itab, sitab, p_col)
