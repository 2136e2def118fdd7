"""Salsa20/20 stream cipher — the framework's cryptographic PRNG.

Replacement for the reference's qhasm-generated x86-64 assembly
stream (reference lib/prng/nfl_crypto_stream_salsa20_amd64_xmm6.s, driven by
lib/prng/fastrandombytes.cpp:21-34): the same crypto_stream_salsa20 function
(32-byte key, 8-byte nonce, 64-bit little-endian block counter starting at 0,
keystream = serialized final state words, little-endian), producing an
identical byte stream for identical (key, nonce).

Three execution tiers share one core:
  * numpy (host)  — vectorized across blocks; used by host-side samplers.
  * jnp (device)  — identical code via the array-namespace parameter; jit.
  * native (host) — optional C++ implementation (csrc/salsa20.c) via ctypes,
                    mirroring the reference's native PRNG tier; used
                    automatically when built.

`Salsa20Stream` reproduces fastrandombytes' statefulness: every call generates
from block counter 0 under the current nonce, then increments the 64-bit
little-endian nonce by one (reference fastrandombytes.cpp:28-33).
"""
from __future__ import annotations

import numpy as np

SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
KEY_BYTES = 32
NONCE_BYTES = 8
BLOCK_BYTES = 64


def _rotl(x, c, xp):
    c = x.dtype.type(c) if hasattr(x.dtype, "type") else c
    return (x << c) | (x >> (32 - c))


def salsa20_block_words(key_words, nonce_words, counters, xp=np):
    """Salsa20/20 keystream blocks.

    key_words: [8] uint32, nonce_words: [2] uint32, counters: [b] uint64
    (block indices).  Returns [b, 16] uint32 final-state words.
    Works with numpy or jax.numpy via `xp`.
    """
    u32 = xp.uint32
    b = counters.shape[0]
    ctr_lo = (counters & 0xFFFFFFFF).astype(u32)
    ctr_hi = (counters >> 32).astype(u32)

    def bc(v):  # broadcast a scalar word across blocks
        return xp.full((b,), v, dtype=u32)

    x = [
        bc(SIGMA[0]), bc(key_words[0]), bc(key_words[1]), bc(key_words[2]),
        bc(key_words[3]), bc(SIGMA[1]), bc(nonce_words[0]), bc(nonce_words[1]),
        ctr_lo, ctr_hi, bc(SIGMA[2]), bc(key_words[4]),
        bc(key_words[5]), bc(key_words[6]), bc(key_words[7]), bc(SIGMA[3]),
    ]
    j = list(x)  # qr() rebinds list slots (no in-place array mutation below)

    def qr(a, bb, c, d):
        x[bb] = x[bb] ^ _rotl(x[a] + x[d], 7, xp)
        x[c] = x[c] ^ _rotl(x[bb] + x[a], 9, xp)
        x[d] = x[d] ^ _rotl(x[c] + x[bb], 13, xp)
        x[a] = x[a] ^ _rotl(x[d] + x[c], 18, xp)

    for _ in range(10):  # 20 rounds = 10 double rounds
        qr(0, 4, 8, 12)
        qr(5, 9, 13, 1)
        qr(10, 14, 2, 6)
        qr(15, 3, 7, 11)
        qr(0, 1, 2, 3)
        qr(5, 6, 7, 4)
        qr(10, 11, 8, 9)
        qr(15, 12, 13, 14)

    out = [x[i] + j[i] for i in range(16)]
    return xp.stack(out, axis=-1)


def crypto_stream(nbytes: int, nonce: bytes, key: bytes) -> bytes:
    """crypto_stream_salsa20(out, nbytes, nonce, key): keystream bytes."""
    assert len(key) == KEY_BYTES and len(nonce) == NONCE_BYTES
    if nbytes == 0:
        return b""
    kw = np.frombuffer(key, dtype="<u4").astype(np.uint32)
    nw = np.frombuffer(nonce, dtype="<u4").astype(np.uint32)
    nblocks = (nbytes + BLOCK_BYTES - 1) // BLOCK_BYTES
    words = salsa20_block_words(kw, nw, np.arange(nblocks, dtype=np.uint64))
    return words.astype("<u4").tobytes()[:nbytes]


class Salsa20Stream:
    """fastrandombytes-equivalent stateful stream (nonce bumped per call).

    Uses the native C++ tier (csrc/nfl_native.cpp via nfllib_tpu.native) when
    a compiler is available, the vectorized numpy tier otherwise — both emit
    the identical byte stream (golden-anchored in tests)."""

    def __init__(self, key: bytes, nonce: int = 0):
        if len(key) != KEY_BYTES:
            raise ValueError("Salsa20 key must be 32 bytes")
        self.key = bytes(key)
        self.nonce = int(nonce)
        from .. import native
        self._native = native if native.available() else None

    @classmethod
    def from_system_entropy(cls) -> "Salsa20Stream":
        from .entropy import randombytes
        return cls(randombytes(KEY_BYTES))

    def randombytes(self, nbytes: int) -> bytes:
        if self._native is not None:
            out = self._native.salsa20_stream(
                nbytes, int(self.nonce).to_bytes(NONCE_BYTES, "little"),
                self.key)
        else:
            out = crypto_stream(
                nbytes, int(self.nonce).to_bytes(NONCE_BYTES, "little"),
                self.key)
        self.nonce = (self.nonce + 1) & 0xFFFFFFFFFFFFFFFF
        return out

    def random_words(self, count: int, dtype) -> np.ndarray:
        """Keystream reinterpreted as little-endian words of `dtype`."""
        itemsize = np.dtype(dtype).itemsize
        buf = self.randombytes(count * itemsize)
        return np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<")).astype(dtype)


def device_stream_words(key: bytes, nonce, nblocks: int):
    """On-device keystream: [nblocks, 16] uint32 words under jit.

    The byte stream equals words.astype('<u4').tobytes() — identical to the
    host/native tiers for the same (key, nonce).  `nonce` may be a python int
    or a traced integer scalar (so nonces can vary without recompilation).
    """
    import jax.numpy as jnp

    kw = jnp.asarray(np.frombuffer(key, dtype="<u4").astype(np.uint32))
    if isinstance(nonce, int):
        nw = jnp.asarray(
            np.frombuffer(int(nonce).to_bytes(8, "little"), dtype="<u4")
            .astype(np.uint32))
    else:
        n64 = nonce.astype(jnp.uint64)
        nw = jnp.stack([(n64 & 0xFFFFFFFF).astype(jnp.uint32),
                        (n64 >> 32).astype(jnp.uint32)])
    counters = jnp.arange(nblocks, dtype=jnp.uint64)
    return salsa20_block_words(kw, nw, counters, xp=jnp)
