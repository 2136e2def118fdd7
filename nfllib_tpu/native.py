"""ctypes loader for the native host runtime (csrc/nfl_native.cpp).

This library's equivalent slot for the reference's native PRNG layer
(the qhasm Salsa20 assembly at lib/prng/*.s + fastrandombytes.cpp).  The
library is built on demand with the system C++ compiler and cached next to
the source; everything degrades gracefully to the numpy tier when no
compiler is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "csrc", "nfl_native.cpp")
_SO = os.path.join(_ROOT, "csrc", "libnfl_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # compile to a per-process temp name and rename atomically, so two
    # concurrent first-use processes can't dlopen a half-written .so
    cxx = os.environ.get("CXX", "g++")
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-fPIC", "-shared", "-std=c++17",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NFL_NO_NATIVE"):
            return None
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.nfl_salsa20_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_char_p]
        lib.nfl_fastrandombytes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        for suffix in ("u16", "u32", "u64"):
            fn = getattr(lib, f"nfl_uniform_{suffix}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def salsa20_stream(nbytes: int, nonce: bytes, key: bytes) -> bytes:
    lib = get_lib()
    assert lib is not None
    out = ctypes.create_string_buffer(nbytes)
    lib.nfl_salsa20_stream(out, nbytes, nonce, key)
    return out.raw


def make_state(key: bytes, nonce: int) -> np.ndarray:
    """40-byte fastrandombytes state: key || little-endian nonce."""
    state = np.frombuffer(
        key + int(nonce).to_bytes(8, "little"), dtype=np.uint8).copy()
    return state


def state_nonce(state: np.ndarray) -> int:
    return int.from_bytes(state[32:].tobytes(), "little")


def fastrandombytes(state: np.ndarray, nbytes: int) -> bytes:
    lib = get_lib()
    assert lib is not None
    out = np.empty(nbytes, dtype=np.uint8)
    lib.nfl_fastrandombytes(state.ctypes.data, out.ctypes.data, nbytes)
    return out.tobytes()


def uniform(state: np.ndarray, moduli: np.ndarray, degree: int,
            modulus_bits: int) -> np.ndarray:
    """Native uniform residue sampling (mask + one conditional subtract)."""
    lib = get_lib()
    assert lib is not None
    dt = moduli.dtype
    suffix = {2: "u16", 4: "u32", 8: "u64"}[dt.itemsize]
    m = len(moduli)
    data = np.empty((m, degree), dtype=dt)
    mask = (1 << modulus_bits) - 1
    getattr(lib, f"nfl_uniform_{suffix}")(
        state.ctypes.data, data.ctypes.data,
        np.ascontiguousarray(moduli).ctypes.data, m, degree, mask)
    return data


# ---------------------------------------------------------------------------
# CRT lifting (native gmp-free bridge; see csrc nfl_poly2mpz/nfl_mpz2poly)
# ---------------------------------------------------------------------------

def _setup_crt(lib):
    if getattr(lib, "_crt_ready", False):
        return
    lib.nfl_poly2mpz.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_uint64] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.nfl_mpz2poly.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_uint64, ctypes.c_uint64,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib._crt_ready = True


def _int_to_words(v: int, W: int) -> np.ndarray:
    return np.frombuffer(
        int(v).to_bytes(W * 8, "little"), dtype="<u8").astype(np.uint64)


def poly2mpz_native(residues: np.ndarray, ctx) -> list:
    """residues [m, n] -> list of python ints (canonical mod prod)."""
    lib = get_lib()
    _setup_crt(lib)
    m, n = residues.shape
    prod = ctx.moduli_product
    W = (prod.bit_length() + 63) // 64
    qtab = np.empty((m, W), dtype=np.uint64)
    invtab = np.empty(m, dtype=np.uint64)
    for cm in range(m):
        p = int(ctx.ring.moduli[cm])
        q = prod // p
        qtab[cm] = _int_to_words(q, W)
        invtab[cm] = pow(q, -1, p)
    prodw = _int_to_words(prod, W)
    mod = np.array([int(x) for x in ctx.ring.moduli], dtype=np.uint64)
    res64 = np.ascontiguousarray(residues.astype(np.uint64))
    out = np.zeros((n, W), dtype=np.uint64)
    scratch = np.zeros(W + 1, dtype=np.uint64)
    lib.nfl_poly2mpz(res64.ctypes.data, qtab.ctypes.data, invtab.ctypes.data,
                     prodw.ctypes.data, mod.ctypes.data, m, n, W,
                     out.ctypes.data, scratch.ctypes.data)
    return [int.from_bytes(out[i].tobytes(), "little") for i in range(n)]


def mpz2poly_native(values, ring) -> np.ndarray:
    """list of nonnegative python ints -> residues [m, n] in the limb dtype."""
    lib = get_lib()
    _setup_crt(lib)
    n, m = ring.degree, ring.nmoduli
    maxbits = max((int(v).bit_length() for v in values), default=1)
    W = max(1, (maxbits + 63) // 64)
    coeffs = np.empty((n, W), dtype=np.uint64)
    for i, v in enumerate(values):
        coeffs[i] = _int_to_words(int(v), W)
    mod = np.array([int(x) for x in ring.moduli], dtype=np.uint64)
    out = np.zeros((m, n), dtype=np.uint64)
    lib.nfl_mpz2poly(coeffs.ctypes.data, m, n, W, mod.ctypes.data,
                     out.ctypes.data)
    return out.astype(ring.dtype)


# ---------------------------------------------------------------------------
# Discrete Gaussian walk (native tier of prng/gaussian.py)
# ---------------------------------------------------------------------------

def _setup_gaussian(lib):
    if getattr(lib, "_gauss_ready", False):
        return
    lib.nfl_gaussian_noise.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    lib._gauss_ready = True


def flatten_gaussian_tables(fg):
    """Flatten a FastGaussianNoise's lookup structures for the C walk."""
    size = fg._lu_size
    lu_val = np.ascontiguousarray(fg.lu_val.astype(np.int64))
    lu_flag = np.ascontiguousarray(fg.lu_flag.astype(np.uint8))
    lu1_map = np.full(size, -1, dtype=np.int32)
    bars1_first = np.zeros(size, dtype=np.int32)
    bars1_count = np.zeros(size, dtype=np.int32)
    if fg.lu_depth == 1:
        for w0, lst in enumerate(fg.lu_barriers):
            if lst:
                bars1_first[w0] = lst[0]
                bars1_count[w0] = len(lst)
        val2 = np.zeros((1, size), dtype=np.int64)
        flag2 = np.zeros((1, size), dtype=np.uint8)
        bars2_first = np.zeros((1, size), dtype=np.int32)
        bars2_count = np.zeros((1, size), dtype=np.int32)
    else:
        keys = sorted(fg.lu2.keys())
        nf = max(1, len(keys))
        val2 = np.zeros((nf, size), dtype=np.int64)
        flag2 = np.zeros((nf, size), dtype=np.uint8)
        bars2_first = np.zeros((nf, size), dtype=np.int32)
        bars2_count = np.zeros((nf, size), dtype=np.int32)
        for f, w0 in enumerate(keys):
            lu1_map[w0] = f
            v2, fl2, b2 = fg.lu2[w0]
            val2[f] = v2.astype(np.int64)
            flag2[f] = fl2.astype(np.uint8)
            for w1, lst in b2.items():
                bars2_first[f, w1] = lst[0]
                bars2_count[f, w1] = len(lst)
    bw = np.ascontiguousarray(fg.barrier_words.astype(np.uint16))
    return dict(lu_val=lu_val, lu_flag=lu_flag, lu1_map=lu1_map,
                bars1_first=bars1_first, bars1_count=bars1_count,
                val2=val2, flag2=flag2, bars2_first=bars2_first,
                bars2_count=bars2_count, barrier_words=bw)


def gaussian_noise(fg, tables: dict, state: np.ndarray,
                   rlen: int) -> np.ndarray:
    """Run the native walk; mutates `state` exactly like the python walk."""
    lib = get_lib()
    _setup_gaussian(lib)
    innoise_words = int(np.float32(rlen) * np.float32(fg.innoise_multiplier))
    out = np.empty(rlen, dtype=np.int64)
    t = tables
    lib.nfl_gaussian_noise(
        state.ctypes.data, out.ctypes.data, rlen,
        fg.word_precision, fg.in_bits // 8, innoise_words,
        t["lu_val"].ctypes.data, t["lu_flag"].ctypes.data,
        t["lu1_map"].ctypes.data, t["bars1_first"].ctypes.data,
        t["bars1_count"].ctypes.data,
        t["val2"].ctypes.data, t["flag2"].ctypes.data,
        t["bars2_first"].ctypes.data, t["bars2_count"].ctypes.data,
        t["barrier_words"].ctypes.data, fg.lu_depth, fg._lu_size)
    return out
