"""Ring definitions and precomputed NTT/CRT constant tables.

Replacement for the reference's static per-type singletons
(`poly::core base`, reference include/nfl/poly.hpp:200-247 + core.hpp:625-686,
and `poly::GMP gmp`, gmp.hpp:113-155).  Instead of compile-time template
instantiation, a `Ring` is a frozen, hashable dataclass; its constant tables
are built once on the host in exact integer arithmetic and cached per ring.

Tables are numpy arrays in the limb dtype, laid out exactly like the
reference's so NTT outputs are bit-identical:
  phis[m, n]                      phi^i (phi = 2n-th root, Harvey pre-twist)
  shoupphis[m, n]                 floor(phi^i 2^w / p)
  invpoly_times_invphis[m, n]     n^-1 * phi^-i
  shoupinvpoly_times_invphis[m,n] Shoup companions
  omegas[m, n-1]                  Harvey blocked twiddles: for K = n, n/2, .., 2
                                  the block [w_K^i for i < K/2], w_K = omega^(n/K)
  shoupomegas[m, n-1]             Shoup companions
  invomegas / shoupinvomegas      same for omega^-1 (inverse transform)
  invpolyDegree[m]                n^-1 mod p
(reference core.hpp:564-581 prep_wtab, core.hpp:625-686 initialize()).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .params import LimbParams, get_limb_params
from .utils import bitrev_indices, is_power_of_two, static_log2


@dataclasses.dataclass(frozen=True)
class Ring:
    """A ring R_q = Z_q[X]/(X^n + 1), q = product of `nmoduli` RNS primes.

    Equivalent of the reference's compile-time triple poly<T, Degree, NbModuli>
    with the static_assert validation of core.hpp:55-60 done at construction.
    """
    limb: str          # "u16" | "u32" | "u64"
    degree: int        # n, power of two
    nmoduli: int       # number of RNS residue channels

    def __post_init__(self):
        lp = self.limb_params
        if not is_power_of_two(self.degree):
            raise ValueError(f"degree {self.degree} is not a power of two")
        if self.degree > lp.max_poly_degree:
            raise ValueError(
                f"degree {self.degree} > kMaxPolyDegree {lp.max_poly_degree}")
        if not 1 <= self.nmoduli <= lp.max_nb_moduli:
            raise ValueError(
                f"nmoduli {self.nmoduli} out of range [1, {lp.max_nb_moduli}]")

    @property
    def limb_params(self) -> LimbParams:
        return get_limb_params(self.limb)

    @property
    def moduli(self) -> tuple:
        return self.limb_params.P[: self.nmoduli]

    @property
    def dtype(self):
        return self.limb_params.dtype

    @property
    def repr_bits(self) -> int:
        return self.limb_params.repr_bits

    @property
    def modulus_bits(self) -> int:
        return self.limb_params.modulus_bits

    @property
    def aggregated_modulus_bit_size(self) -> int:
        return self.nmoduli * self.modulus_bits

    @property
    def shape(self) -> tuple:
        return (self.nmoduli, self.degree)

    def context(self) -> "RingContext":
        return get_context(self)


def ring_from_modulus(limb: str, degree: int, aggregated_bits: int) -> Ring:
    """poly_from_modulus equivalent (reference poly.hpp:336-337)."""
    mbits = get_limb_params(limb).modulus_bits
    if aggregated_bits % mbits != 0:
        raise ValueError(
            f"aggregated modulus size {aggregated_bits} not a multiple of "
            f"the {mbits}-bit modulus size")
    return Ring(limb, degree, aggregated_bits // mbits)


# ---------------------------------------------------------------------------
# Exact host-side table construction
# ---------------------------------------------------------------------------

def _powers_mod(base: int, count: int, p: int, start: int = 1, obj: bool = False):
    """[start * base^i mod p for i < count] via doubling, exact arithmetic.

    u16/u32 limbs: plain uint64 numpy.  u64 limb (obj=True, kept for the
    callers' dtype contract): vectorized pair-Barrett (_np_mulmod_vec) —
    O(n) numpy work instead of O(n) python-int multiplications, which
    matters at n = 2^20."""
    out = np.empty(count, dtype=np.uint64)
    if count == 0:
        return out
    out[0] = start % p
    filled = 1
    step = base % p
    while filled < count:
        take = min(filled, count - filled)
        if obj:
            out[filled:filled + take] = _np_mulmod_vec(
                out[:take], np.uint64(step), p)
        else:
            out[filled:filled + take] = (out[:take] * np.uint64(step)) \
                % np.uint64(p)
        step = (step * step) % p
        filled += take
    return out


def _shoup_arr(vals, p: int, w: int, obj: bool):
    """floor(v << w / p) elementwise, exact (vectorized for every tier)."""
    if obj:
        v64 = np.asarray(vals).astype(np.uint64)    # values < p < 2^62
        return _np_shoup_vec(v64, p, w)
    return ((vals.astype(np.uint64) << np.uint64(w)) // np.uint64(p))


# ---------------------------------------------------------------------------
# vectorized host modular arithmetic (uint64 numpy — no object arrays)
#
# The four-step twiddle tables are [m, n1, n2] = up to a million entries per
# channel at n = 2^20; building them with python-int object math is O(n)
# interpreter work.  These helpers run the same exact math vectorized in
# numpy uint64 (the 62-bit tier uses the same pair/Barrett formulations as
# the device code: _mulhi_u64 via 32-bit splits, m = floor(2^124/p),
# F = floor(2^125/p)).
# ---------------------------------------------------------------------------

def _np_mulhi_u64(x, y):
    m32 = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    xl, xh = x & m32, x >> s32
    yl, yh = y & m32, y >> s32
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = (ll >> s32) + (lh & m32) + (hl & m32)
    return hh + (lh >> s32) + (hl >> s32) + (mid >> s32)


def _np_mulmod_vec(a, b, p: int):
    """a * b mod p for uint64 arrays, exact.

    p < 2^31: plain uint64 products.  2^61 < p < 2^62 (the u64 tier):
    Barrett with m = floor(2^124/p) — q = hi64((v >> 60) * m) satisfies
    q > v/p - 3, so r = v - q*p < 4p < 2^64 exact in wrapping uint64."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    if p < (1 << 31):
        return (a * b) % np.uint64(p)
    assert p > (1 << 61), "u64 Barrett needs 62-bit moduli"
    mbar = np.uint64((1 << 124) // p)
    pv = np.uint64(p)
    hi = _np_mulhi_u64(a, b)
    lo = a * b
    a60 = (hi << np.uint64(4)) | (lo >> np.uint64(60))
    q = _np_mulhi_u64(a60, mbar)
    r = lo - q * pv
    two_p = np.uint64(2 * p)
    r = np.where(r >= two_p, r - two_p, r)
    return np.where(r >= pv, r - pv, r)


def _np_shoup_vec(t, p: int, w: int):
    """floor(t << w / p) for uint64 arrays of canonical residues, exact.

    w <= 32: plain uint64 shifts.  w == 64 (u64 tier): the compute_shoup
    Barrett — F = floor(2^125/p), qhat = floor(t*F/2^61) in [q-3, q],
    r = -qhat*p (wrapping) < 4p, three fixups."""
    t = np.asarray(t, dtype=np.uint64)
    if w <= 32:
        return (t << np.uint64(w)) // np.uint64(p)
    assert w == 64 and p > (1 << 61)
    F = np.uint64((1 << 125) // p)
    pv = np.uint64(p)
    hi = _np_mulhi_u64(t, F)
    lo = t * F
    qhat = (hi << np.uint64(3)) | (lo >> np.uint64(61))
    r = np.uint64(0) - qhat * pv
    for _ in range(3):
        ge = r >= pv
        r = np.where(ge, r - pv, r)
        qhat = qhat + ge.astype(np.uint64)
    return qhat


class RingContext:
    """Precomputed constants for one Ring (host numpy, exact)."""

    def __init__(self, ring: Ring):
        self.ring = ring
        lp = ring.limb_params
        n, m = ring.degree, ring.nmoduli
        w = lp.repr_bits
        dtype = lp.dtype
        obj = ring.limb == "u64"

        self.p = np.array(ring.moduli, dtype=dtype)
        self.pn = np.array(lp.Pn[:m], dtype=dtype)
        # column views broadcasting against [..., m, n] residue tensors
        self.p_col = self.p.reshape(m, 1)
        self.pn_col = self.pn.reshape(m, 1)

        self.phis = np.empty((m, n), dtype=dtype)
        self.shoupphis = np.empty((m, n), dtype=dtype)
        self.invpoly_times_invphis = np.empty((m, n), dtype=dtype)
        self.shoupinvpoly_times_invphis = np.empty((m, n), dtype=dtype)
        self.omegas = np.empty((m, max(n - 1, 1)), dtype=dtype)
        self.shoupomegas = np.empty((m, max(n - 1, 1)), dtype=dtype)
        self.invomegas = np.empty((m, max(n - 1, 1)), dtype=dtype)
        self.shoupinvomegas = np.empty((m, max(n - 1, 1)), dtype=dtype)
        self.invpolyDegree = np.empty((m,), dtype=dtype)
        # natural-order omega powers (for matmul/four-step NTT variants)
        self.omega_pows = np.empty((m, n), dtype=dtype)
        self.invomega_pows = np.empty((m, n), dtype=dtype)
        self.phi_int = []        # python ints, per channel
        self.omega_int = []

        log_nmax = static_log2(lp.max_poly_degree)
        log_n = static_log2(n)

        for cm in range(m):
            p = int(ring.moduli[cm])
            # phi: square the primitive 2*kMaxPolyDegree-th root down to a
            # primitive 2n-th root (reference core.hpp:640-645)
            phi = int(lp.primitive_roots[cm])
            for _ in range(log_nmax - log_n):
                phi = (phi * phi) % p
            invphi = pow(phi, -1, p)
            omega = (phi * phi) % p
            invomega = pow(omega, -1, p)
            self.phi_int.append(phi)
            self.omega_int.append(omega)

            phis = _powers_mod(phi, n, p, obj=obj)
            self.phis[cm] = phis.astype(dtype)
            self.shoupphis[cm] = _shoup_arr(phis, p, w, obj).astype(dtype)

            # n^-1 = invkMaxPolyDegree * (kMaxPolyDegree / n) mod p
            # (reference core.hpp:663-665)
            inv_deg = (int(lp.inv_max_poly_degree[cm])
                       * (lp.max_poly_degree // n)) % p
            self.invpolyDegree[cm] = dtype(inv_deg)
            itab = _powers_mod(invphi, n, p, start=inv_deg, obj=obj)
            self.invpoly_times_invphis[cm] = itab.astype(dtype)
            self.shoupinvpoly_times_invphis[cm] = _shoup_arr(
                itab, p, w, obj).astype(dtype)

            wpows = _powers_mod(omega, n, p, obj=obj)
            iwpows = _powers_mod(invomega, n, p, obj=obj)
            self.omega_pows[cm] = wpows.astype(dtype)
            self.invomega_pows[cm] = iwpows.astype(dtype)

            if n >= 2:
                blocked = _harvey_blocked(wpows, n)
                iblocked = _harvey_blocked(iwpows, n)
                self.omegas[cm] = blocked.astype(dtype)
                self.shoupomegas[cm] = _shoup_arr(blocked, p, w, obj).astype(dtype)
                self.invomegas[cm] = iblocked.astype(dtype)
                self.shoupinvomegas[cm] = _shoup_arr(
                    iblocked, p, w, obj).astype(dtype)

        self.bitrev = bitrev_indices(n)
        # per-stage views of the blocked twiddles: stage s uses a block of
        # length n >> (s+1) starting at offset n - (n >> s)
        self.stage_offsets = []
        off = 0
        k = n
        while k >= 2:
            self.stage_offsets.append((off, k // 2))
            off += k // 2
            k //= 2

        # --- CRT lift constants (reference gmp.hpp:113-155), python ints ---
        prod = 1
        for p in ring.moduli:
            prod *= int(p)
        self.moduli_product = prod
        self.bits_in_moduli_product = prod.bit_length()
        self.lifting_integers = []
        for cm in range(m):
            p = int(ring.moduli[cm])
            q = prod // p
            self.lifting_integers.append((pow(q, -1, p) * q) % prod)

    # convenience: row-major [m, n] tables as jnp on default device happen
    # automatically when passed to jnp ops; no explicit device cache yet.


def _harvey_blocked(wpows, n):
    """Concatenate blocks [w^(2^l * i), i < n/2^(l+1)] for l = 0.. (K=n..2).

    Matches reference prep_wtab's ordering (core.hpp:564-581): entries for
    level l are powers of omega^(2^l).
    """
    parts = []
    l = 0
    k = n
    while k >= 2:
        idx = (np.arange(k // 2) << l)
        parts.append(wpows[idx])
        k //= 2
        l += 1
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def get_context(ring: Ring) -> RingContext:
    return RingContext(ring)
