"""LWE-like symmetric encryption — the end-to-end acceptance workload.

Reproduces the reference demo's scheme exactly (reference
tests/nfllib_demo_main_op.cpp:26-58,260-331):

  keygen:  s ~ gaussian, NTT'd; sprime = compute_shoup(s)
           pka ~ uniform (already NTT domain); pkb ~ 2*gaussian, NTT'd;
           pkb += shoup(pka * s, sprime)
  encrypt: u ~ gaussian, e1,e2 ~ 2*gaussian, each NTT'd;
           resa = u*pka + e1 ; resb = u*pkb + e2        (fused chains)
  decrypt: tmp = resb - resa*s ; inverse NTT;
           bit = coeff % 2 if coeff < p0/2 else 1 - coeff % 2

Sampling runs on the host stream (deterministic given key/nonce); the compute
graph (NTT, fused mulmod/muladd chains) is pure jnp and jit-compiled — sums of
decryptions of encryptions of zero must be exactly zero.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp

from ..ops import modops, ntt
from ..poly import Poly, compute_shoup, shoup
from ..prng.gaussian import FastGaussianNoise
from ..prng.salsa20 import Salsa20Stream
from ..prng.sampling import gaussian, uniform
from ..ring import Ring

SIGMA = 4.0  # demo parameters (nfllib_demo_main_op.cpp:8-9)


@dataclasses.dataclass
class LweKeys:
    s: Poly        # secret key, NTT domain
    sprime: Poly   # Shoup companion
    pka: Poly      # public key part a, NTT domain
    pkb: Poly      # public key part b, NTT domain


def make_gaussian_prng(security: int = 128, samples: int = 1 << 10,
                       sigma: float = SIGMA) -> FastGaussianNoise:
    return FastGaussianNoise(sigma, security, samples)


def keygen(ring: Ring, stream: Salsa20Stream,
           g_prng: FastGaussianNoise) -> LweKeys:
    s = Poly.sample(ring, gaussian(g_prng), stream).ntt_pow_phi()
    sprime = compute_shoup(s)
    pka = Poly.sample(ring, uniform(), stream)
    pkb = Poly.sample(ring, gaussian(g_prng, 2), stream).ntt_pow_phi()
    # force the lazy chain: keys are long-lived Polys, not deferred Exprs
    pkb = (pkb + shoup(pka * s, sprime)).poly()
    return LweKeys(s=s, sprime=sprime, pka=pka, pkb=pkb)


def _encrypt_graph(ctx, pka, pkb, u, e1, e2):
    """Pure compute graph on residue tensors; u/e1/e2 are coefficient-domain
    noise, outputs are the NTT-domain ciphertext halves."""
    p_col = jnp.asarray(ctx.p_col)
    pn_col = jnp.asarray(ctx.pn_col)
    un = ntt.ntt_pow_phi(u, ctx)
    e1n = ntt.ntt_pow_phi(e1, ctx)
    e2n = ntt.ntt_pow_phi(e2, ctx)
    resa = modops.muladd(e1n, un, pka, p_col, pn_col)
    resb = modops.muladd(e2n, un, pkb, p_col, pn_col)
    return resa, resb


def _decrypt_graph(ctx, resa, resb, s, sprime):
    p_col = jnp.asarray(ctx.p_col)
    pn_col = jnp.asarray(ctx.pn_col)
    tmp = modops.submod(resb, modops.mulmod(resa, s, p_col, pn_col), p_col)
    tmp = ntt.invntt_pow_invphi(tmp, ctx)
    p0 = jnp.asarray(ctx.p[0])
    half = p0 // jnp.asarray(2, dtype=p0.dtype)
    bit = tmp % jnp.asarray(2, dtype=tmp.dtype)
    return jnp.where(tmp < half, bit,
                     jnp.asarray(1, dtype=tmp.dtype) - bit)


@functools.lru_cache(maxsize=None)
def _jitted_graphs(ring: Ring):
    ctx = ring.context()
    enc = jax.jit(functools.partial(_encrypt_graph, ctx))
    dec = jax.jit(functools.partial(_decrypt_graph, ctx))
    return enc, dec


def encrypt(keys: LweKeys, ring: Ring, stream: Salsa20Stream,
            g_prng: FastGaussianNoise):
    """One encryption of zero (reference encrypt(), demo_main_op.cpp:26-45)."""
    u = Poly.sample(ring, gaussian(g_prng), stream)
    e1 = Poly.sample(ring, gaussian(g_prng, 2), stream)
    e2 = Poly.sample(ring, gaussian(g_prng, 2), stream)
    enc, _ = _jitted_graphs(ring)
    resa, resb = enc(keys.pka.data, keys.pkb.data, u.data, e1.data, e2.data)
    return Poly(resa, ring), Poly(resb, ring)


def decrypt(keys: LweKeys, ring: Ring, resa: Poly, resb: Poly):
    """Decrypt to a per-(channel,coefficient) bit tensor (reference
    decrypt(), demo_main_op.cpp:48-58)."""
    _, dec = _jitted_graphs(ring)
    return dec(resa.data, resb.data, keys.s.data, keys.sprime.data)


def run_zero_sum_check(ring: Ring, repetitions: int = 10,
                       key: bytes = None) -> bool:
    """The reference's correctness gate (demo_main_op.cpp:313-331): the sum of
    decryptions of encryptions of zero must be exactly zero."""
    stream = (Salsa20Stream(key) if key is not None
              else Salsa20Stream.from_system_entropy())
    g_prng = make_gaussian_prng()
    keys = keygen(ring, stream, g_prng)
    total = jnp.zeros(ring.shape, dtype=jnp.int64)
    for _ in range(repetitions):
        resa, resb = encrypt(keys, ring, stream, g_prng)
        total = total + decrypt(keys, ring, resa, resb).astype(jnp.int64)
    return bool(jnp.all(total == 0))


# ---------------------------------------------------------------------------
# fully on-device pipeline: sampling fuses into the encrypt graph
# ---------------------------------------------------------------------------

def _encrypt_on_device_graph(ctx, g_prng, key: bytes, nonce, pka, pkb,
                             exact: bool = False):
    """Noise sampling (device Salsa20 Gaussian) and the encrypt chain in
    ONE jittable graph — zero host transfers per message.

    exact=False (default): the fixed-consumption device Gaussian, three
    nonces (u, e1, e2) starting at `nonce` — distribution-equal to the
    host encrypt().
    exact=True: the STREAM-EXACT device Gaussian with in-graph nonce
    chaining (each sampler reports how many fill() calls the host walk
    would make, and the next starts there) — the ciphertexts are
    bit-identical to host encrypt() with a stream at the same
    (key, nonce)."""
    from ..prng.device_sampling import device_gaussian, device_gaussian_exact
    from ..prng.sampling import gaussian as gaussian_mode

    ring = ctx.ring
    if exact:
        u, f0 = device_gaussian_exact(ring, key, nonce,
                                      gaussian_mode(g_prng),
                                      return_fills=True)
        e1, f1 = device_gaussian_exact(ring, key, nonce + f0,
                                       gaussian_mode(g_prng, 2),
                                       return_fills=True)
        e2 = device_gaussian_exact(ring, key, nonce + f0 + f1,
                                   gaussian_mode(g_prng, 2))
    else:
        u = device_gaussian(ring, key, nonce, gaussian_mode(g_prng))
        e1 = device_gaussian(ring, key, nonce + 1, gaussian_mode(g_prng, 2))
        e2 = device_gaussian(ring, key, nonce + 2, gaussian_mode(g_prng, 2))
    return _encrypt_graph(ctx, pka, pkb, u, e1, e2)


def encrypt_on_device(keys: LweKeys, ring: Ring, key: bytes, nonce: int,
                      g_prng: FastGaussianNoise, exact: bool = False):
    """Encrypt a zero with all randomness generated on the accelerator.

    exact=False: distribution-equal to encrypt() (fixed-consumption device
    Gaussian).  exact=True: bit-identical to encrypt() for a host stream
    at the same (key, nonce) — see _encrypt_on_device_graph."""
    enc = _jitted_ondevice(ring, _gaussian_key(g_prng), key, exact)
    resa, resb = enc(keys.pka.data, keys.pkb.data, nonce)
    return Poly(resa, ring), Poly(resb, ring)


def _gaussian_key(g_prng: FastGaussianNoise) -> tuple:
    """Value key for jit caches: a FastGaussianNoise's behavior is fully
    determined by its constructor parameters (gaussian.py:64-88), so caching
    on these is stable — unlike id(), which a GC'd-and-reallocated object
    could silently alias.  The key is derived from the constructor signature
    itself, so adding a parameter to FastGaussianNoise can never silently
    alias distinct samplers here ('verbose' is behavior-neutral output
    chatter and is excluded on purpose)."""
    params = [name for name in
              inspect.signature(FastGaussianNoise.__init__).parameters
              if name not in ("self", "verbose")]
    k = tuple(getattr(g_prng, name) for name in params)
    _GPRNG_BY_KEY.setdefault(k, g_prng)
    return k


@functools.lru_cache(maxsize=None)
def _jitted_ondevice(ring: Ring, g_key: tuple, key: bytes,
                     exact: bool = False):
    ctx = ring.context()
    g_prng = _GPRNG_BY_KEY[g_key]

    def graph(pka, pkb, nonce):
        return _encrypt_on_device_graph(ctx, g_prng, key, nonce, pka, pkb,
                                        exact=exact)

    return jax.jit(graph)


_GPRNG_BY_KEY = {}


def register_gaussian(g_prng) -> tuple:
    """Kept for API compatibility; returns the stable value key."""
    return _gaussian_key(g_prng)
