"""Elementwise modular arithmetic on residue tensors (jnp).

Equivalent of the reference's modular-op functor stratum
(reference: include/nfl/ops.hpp:100-242, include/nfl/opt/ops.hpp:7-78).
Where the reference specializes each op per (scalar type x SIMD engine), here
each op is a jnp function over arrays of any shape; XLA fuses chains of these
into single passes over memory (the expression-template contract of
reference core.hpp:25-37 holds for free under jit).

Conventions:
  * Residues live in their limb dtype (uint16/uint32/uint64) and are < p
    unless an op documents a lazy [0, 2p) contract.
  * Per-channel constants (p, pn, ...) broadcast against the data; the Poly
    layer passes them shaped [nmoduli, 1].
  * All arithmetic relies on the defined wrap-around of jnp unsigned dtypes,
    mirroring the reference's value_type arithmetic.
  * uint64 support requires jax_enable_x64 (enabled by nfllib_tpu.__init__).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import debug

_U16, _U32, _U64 = jnp.uint16, jnp.uint32, jnp.uint64

_WIDER = {jnp.dtype(jnp.uint16): jnp.uint32, jnp.dtype(jnp.uint32): jnp.uint64}
_REPR_BITS = {jnp.dtype(jnp.uint16): 16, jnp.dtype(jnp.uint32): 32,
              jnp.dtype(jnp.uint64): 64}


def repr_bits(dtype) -> int:
    return _REPR_BITS[jnp.dtype(dtype)]


# ---------------------------------------------------------------------------
# double-word helpers
# ---------------------------------------------------------------------------

def mulhi(x, y):
    """High word of the full product, per limb dtype.

    u16 widens to u32; u32 uses a 16-bit-split formulation entirely in
    uint32 lanes (no 64-bit intermediate); u64 splits into 32-bit halves.
    Whether a widening 32x32->64 multiply is faster on a given device is
    left to measurement.
    """
    dt = jnp.dtype(x.dtype)
    if dt == jnp.dtype(jnp.uint16):
        return ((x.astype(_U32) * y.astype(_U32)) >> 16).astype(_U16)
    if dt == jnp.dtype(jnp.uint32):
        return _mulhi_u32(x, y)
    return _mulhi_u64(x, y)


def _mulhi_u32(x, y):
    """High 32 bits of a 32x32 product from 16-bit halves (uint32 lanes only).

    Every intermediate fits in uint32: products of 16-bit halves are < 2^32,
    and mid = (ll>>16) + (lh&m) + (hl&m) < 3*2^16 < 2^32.
    """
    m16 = _U32(0xFFFF)
    xl, xh = x & m16, x >> 16
    yl, yh = y & m16, y >> 16
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = (ll >> 16) + (lh & m16) + (hl & m16)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16)


def _mulhi_u64(x, y):
    """High 64 bits of a 64x64 product from 32-bit halves (no 128-bit type)."""
    m32 = _U64(0xFFFFFFFF)
    xl, xh = x & m32, x >> 32
    yl, yh = y & m32, y >> 32
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = (ll >> 32) + (lh & m32) + (hl & m32)
    return hh + (lh >> 32) + (hl >> 32) + (mid >> 32)


def mul128(x, y):
    """Full 64x64 -> (hi, lo) product."""
    return _mulhi_u64(x, y), x * y


# ---------------------------------------------------------------------------
# core ops (reference ops.hpp semantics)
# ---------------------------------------------------------------------------

def addmod(x, y, p):
    """x + y mod p, assuming x, y < p (reference ops.hpp:124-135)."""
    debug.op_check(p, x, y)
    z = x + y
    return z - jnp.where(z >= p, p, jnp.zeros_like(p)).astype(z.dtype)


def submod(x, y, p):
    """x - y mod p, assuming x, y < p (reference ops.hpp:141-151)."""
    debug.op_check(p, x, y)
    z = x + (p - y).astype(x.dtype)
    return z - jnp.where(z >= p, p, jnp.zeros_like(p)).astype(z.dtype)


def eqmod(x, y):
    return x == y


def neqmod(x, y):
    return x != y


def _barrett_mulmod_u16(x, y, p):
    """x*y mod p for the 14-bit tier, entirely in uint32 lanes.

    z = x*y < 2^28; with m = floor(2^32/p), q = hi32(z*m) satisfies
    Q-2 < q <= Q (Q the true quotient), so z - q*p < 3p < 2^16 and two
    conditional subtracts finish.  No division in the compiled program
    (the m divide is over the [nmoduli,1] constant, folded by XLA).
    """
    p32 = p.astype(_U32)
    m = ((_U64(1) << 32) // p.astype(_U64)).astype(_U32)
    z = x.astype(_U32) * y.astype(_U32)
    q = _mulhi_u32(z, m)
    r = z - q * p32
    r = r - jnp.where(r >= p32, p32, _U32(0))
    r = r - jnp.where(r >= p32, p32, _U32(0))
    return r.astype(_U16)


def _barrett_mulmod_u32(x, y, p):
    """x*y mod p for the 30-bit tier, entirely in uint32 lanes.

    z = x*y < 2^60 as (hi, lo); a = z >> 28 < 2^32, m = floor(2^60/p)
    (fits uint32 because p > 2^29), q = hi32(a*m) = floor(a*m/2^32).
    q*p <= a*2^28 <= z and q > z/p - 3, so r = z - q*p (exact in wrapping
    32-bit arithmetic since r < 4p < 2^32) needs at most a 2p- and a
    p-subtract.  Replaces the widen-to-u64 `%` with multiplies (no integer
    division in the compiled program).
    """
    m = ((_U64(1) << 60) // p.astype(_U64)).astype(_U32)
    p32 = p.astype(_U32)
    two_p = p32 * _U32(2)
    hi = _mulhi_u32(x, y)
    lo = x * y
    a = (hi << 4) | (lo >> 28)
    q = _mulhi_u32(a, m)
    r = lo - q * p32
    r = r - jnp.where(r >= two_p, two_p, _U32(0))
    r = r - jnp.where(r >= p32, p32, _U32(0))
    return r


def mulmod(x, y, p, pn=None):
    """x * y mod p (generic path, reference ops.hpp:183-219).

    The reference widens u16/u32 and uses `%`; here those tiers use a
    Barrett reduction in 32-bit lanes instead, which needs no integer
    division (bit-identical results).
    u64: Newton-quotient reduction with the precomputed Pn low word
    (reference ops.hpp:201-219), since no 128-bit dtype exists on device.
    """
    debug.op_check(p, x, y)
    dt = jnp.dtype(x.dtype)
    if dt == jnp.dtype(jnp.uint16):
        return _barrett_mulmod_u16(x, y, p)
    if dt == jnp.dtype(jnp.uint32):
        return _barrett_mulmod_u32(x, y, p)
    assert pn is not None, "mulmod on uint64 requires the Newton quotient pn"
    hi, lo = mul128(x, y)
    # q = Pn * (res >> 64) + (res << 2), keep only q >> 64
    s_hi = (hi << 2) | (lo >> 62)
    s_lo = lo << 2
    q_lo = pn * hi + s_lo
    carry = jnp.where(q_lo < s_lo, _U64(1), _U64(0))
    q_hi = _mulhi_u64(pn, hi) + s_hi + carry
    r = lo - q_hi * p
    return r - jnp.where(r >= p, p, _U64(0))


def compute_shoup(y, p):
    """floor(y * 2^w / p) for Shoup multiplication (reference ops.hpp:165-177).

    Input is reduced mod p first, mirroring the reference's while-loop.
    """
    dt = jnp.dtype(y.dtype)
    if dt in _WIDER:
        w = _WIDER[dt]
        wbits = int(repr_bits(dt))
        if not isinstance(p, jax.core.Tracer):
            # Barrett in the wider lanes: replace % and // with two
            # multiplies (no integer division in the compiled program)
            # when p is a trace-time constant of the tier's standard
            # modulus width (u16: 14-bit, u32: 30-bit — every params.py
            # prime).  b = wbits-2, F = floor(2^(2b)/p) per modulus:
            #   qy   = floor(y*F/2^2b)  in [floor(y/p)-1, floor(y/p)]
            #          (y < 2^w, F < 2^(w-1) -> y*F < 2^(2w-1) fits; the
            #          slack p*y/2^2b < 4 -> yr < p+4 < 2p, one subtract)
            #   qhat = floor(yr*F/2^(2b-w)) in [q-3, q] (yr < p, yr*F <
            #          2^2b fits; slack yr/2^(2b-w) < 2^(w-b) = 4)
            #   r    = yr*2^w - qhat*p < 5p fits the wider lanes; <= 4
            #          conditional corrections make qhat exact.
            ph = np.asarray(p)
            bl = {int(v).bit_length() for v in ph.reshape(-1)}
            if bl == {wbits - 2}:
                b2 = 2 * (wbits - 2)
                F = jnp.asarray(np.array(
                    [(1 << b2) // int(v) for v in ph.reshape(-1)],
                    dtype=np.dtype(w)).reshape(ph.shape))
                yw = y.astype(w)
                pw = jnp.asarray(ph).astype(w)
                qy = (yw * F) >> b2
                yr = yw - qy * pw
                yr = yr - jnp.where(yr >= pw, pw, 0).astype(w)
                qhat = (yr * F) >> (b2 - wbits)
                r = (yr << wbits) - qhat * pw
                for _ in range(4):
                    ge = r >= pw
                    qhat = qhat + ge.astype(w)
                    r = r - jnp.where(ge, pw, 0).astype(w)
                return qhat.astype(dt)
        yr = (y.astype(w) % p.astype(w))
        return ((yr << repr_bits(dt)) // p.astype(w)).astype(dt)
    # uint64: Barrett with F = floor(2^125 / p), which fits u64 for the
    # 62-bit tier (p > 2^61).  F comes from exact host integer math over the
    # constant moduli (every caller closes over numpy p tables, so p is a
    # trace-time constant); the device path is two emulated 64x64 mulhi's
    # plus bounded fixups — O(1) per element vs the O(64) restoring
    # division it replaces.
    if isinstance(p, jax.core.Tracer):
        # traced p (no host value): restoring division fallback
        y = y % p
        def step(_, qr):
            q, r = qr
            r2 = r << 1                   # r < p < 2^62 so no overflow
            ge = r2 >= p
            return (q << 1) | ge.astype(_U64), r2 - jnp.where(ge, p, _U64(0))
        q, _ = lax.fori_loop(0, 64, step, (jnp.zeros_like(y), y))
        return q
    p_host = np.asarray(p, dtype=np.uint64)
    assert int(p_host.min()) > (1 << 61), "u64 Barrett needs 62-bit moduli"
    F = jnp.asarray(np.array(
        [(1 << 125) // int(v) for v in p_host.reshape(-1)],
        dtype=np.uint64).reshape(p_host.shape))
    # reduce y mod p: qy = floor(y*F/2^125) >= floor(y/p) - 2, so yr < 3p
    qy = _mulhi_u64(y, F) >> _U64(61)
    yr = y - qy * p
    yr = yr - jnp.where(yr >= p, p, _U64(0))
    yr = yr - jnp.where(yr >= p, p, _U64(0))
    # q = floor(yr * 2^64 / p): qhat = floor(yr*F/2^61) in [q-3, q], so
    # r = yr*2^64 - qhat*p < 4p < 2^64 — exact in wrapping u64 as -qhat*p
    hi = _mulhi_u64(yr, F)
    lo = yr * F
    qhat = (hi << _U64(3)) | (lo >> _U64(61))
    r = _U64(0) - qhat * p
    for _ in range(3):
        ge = r >= p
        r = r - jnp.where(ge, p, _U64(0))
        qhat = qhat + ge.astype(_U64)
    return qhat


def mulmod_shoup(x, y, yprime, p):
    """x * y mod p with precomputed yprime = floor(y 2^w / p).

    Reference ops.hpp:225-242: q = hi(x * yprime); r = x*y - q*p in wrapping
    word arithmetic; one conditional subtract.  Exact for x, y < p when p has
    two spare bits in the limb (14/30/62-bit moduli do).
    """
    debug.op_check(p, x, y)
    q = mulhi(x, yprime)
    r = x * y - q * p
    return r - jnp.where(r >= p, p, jnp.zeros_like(p)).astype(r.dtype)


def mulmod_shoup_lazy(x, y, yprime, p):
    """Same as mulmod_shoup without the final correction: result in [0, 2p)."""
    q = mulhi(x, yprime)
    return x * y - q * p


def muladd(rop, x, y, p, pn=None):
    """rop + x*y mod p (reference opt/ops.hpp:7-48): division-free
    mulmod then a conditional-subtract add, all lanes-native."""
    debug.op_check(p, rop, x, y)
    dt = jnp.dtype(x.dtype)
    if dt == jnp.dtype(jnp.uint16):
        r = _barrett_mulmod_u16(x, y, p)
    elif dt == jnp.dtype(jnp.uint32):
        r = _barrett_mulmod_u32(x, y, p)
    else:
        r = mulmod(x, y, p, pn)
    r = r + rop
    return r - jnp.where(r >= p, p, jnp.zeros_like(p)).astype(r.dtype)


def muladd_shoup(rop, x, y, yprime, p):
    """rop + x*y mod p via Shoup (reference opt/ops.hpp:54-78)."""
    debug.op_check(p, rop, x, y)
    q = mulhi(x, yprime)
    r = rop + (x * y - q * p)
    return r - jnp.where(r >= p, p, jnp.zeros_like(p)).astype(r.dtype)


def reduce_once(x, p):
    """One conditional subtract: maps [0, 2p) -> [0, p)."""
    return x - jnp.where(x >= p, p, jnp.zeros_like(p)).astype(x.dtype)
