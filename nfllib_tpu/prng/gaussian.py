"""Discrete Gaussian noise generator (FastGaussianNoise equivalent).

Re-design of the reference's CDF-inversion sampler
(reference include/nfl/prng/FastGaussianNoise.hpp:41-654):

  * security accounting: k = security + 1 + ceil(log2(samples)); tail bound
    via the same Newton-Raphson iteration on t^2 - 2 ln t - 1 - 2k ln 2
    (FastGaussianNoise.hpp:136-158,250-264);
  * bit precision = ceil(k + log2(2*t*sigma)) rounded up to whole input words
    (:266-271); number_of_barriers = 1 + 2*ceil(t*sigma) (:275);
  * "barriers" = cumulative probabilities of exp(-(v-c)^2/(2 sigma^2)) at the
    integer points, normalized by (2^prec - 1)/SUM and rounded to integers —
    computed by replaying the reference's exact MPFR op sequence against
    libmpfr via ctypes (mpfr_barriers.py), so they are bit-identical to the
    reference's (:296-368; anchored by tests/test_golden_interop.py).  When
    libmpfr is absent the same sequence is replayed with Python integers and
    `decimal`, rounding as MPFR does after every op.
  * host sampling reproduces the reference's *stream consumption* exactly:
    a 1.05/2.0/word_precision-weighted input buffer drawn in one
    fastrandombytes call, two-level uint8 lookup, full-precision barrier walk
    on flagged entries, buffer regeneration when nearly exhausted (:478-595);
  * device sampling is the branchless reformulation: every sample consumes a
    fixed word_precision bytes and the output is
      base_value + (number of barriers <= r)   (big-endian r),
    exactly the fixed point the reference's early-exit LUT walk computes.
"""
from __future__ import annotations

import math

import numpy as np

from .salsa20 import Salsa20Stream


def newton_raphson(k: float, max_guess: float, digits: int) -> float:
    """Tail-bound solver, same float64 iteration as the reference
    (FastGaussianNoise.hpp:136-158)."""
    guess = max_guess
    for _ in range(1 << 15):
        f = guess * guess - 2 * math.log(guess) - 1 - 2 * k * math.log(2)
        fp = 2 * guess - 2 / guess
        delta = f / fp
        guess -= delta
        if abs(delta) / abs(guess) < 10.0 ** (-digits):
            break
    while (0.95 * guess) ** 2 - 2 * math.log(0.95 * guess) - 1 \
            - 2 * k * math.log(2) >= 0:
        guess *= 0.95
    if guess * guess - 2 * math.log(guess) - 1 - 2 * k * math.log(2) < 0:
        raise RuntimeError("Newton-Raphson failed; generator not secure")
    return guess


class FastGaussianNoise:
    """Discrete Gaussian sampler over the integers.

    in_bits: bits per lookup word (8 -> uint8 LUTs, the reference default).
    lu_depth: 1 or 2 lookup levels (reference template parameter).
    """

    def __init__(self, sigma: float, security: int, samples: int,
                 center: float = 0.0, in_bits: int = 8, lu_depth: int = 2,
                 verbose: bool = False):
        if lu_depth not in (1, 2):
            raise ValueError("lu_depth must be 1 or 2")
        if in_bits not in (8, 16):
            raise ValueError("in_bits must be 8 or 16")
        self.sigma = float(sigma)
        self.security = int(security)
        self.samples = int(samples)
        self.center = float(center)
        self.rounded_center = int(round(center))
        self.in_bits = in_bits
        self.lu_depth = lu_depth
        self._lu_size = 1 << in_bits

        # init() (FastGaussianNoise.hpp:232-292)
        k = self.security + 1 + math.ceil(math.log(self.samples) / math.log(2))
        min_guess = math.sqrt(1 + 2 * k * math.log(2))
        self.tail_bound = newton_raphson(k, min_guess, 3)
        epsi = k + math.log2(2 * self.tail_bound * self.sigma)
        bit_precision = math.ceil(epsi)
        self.word_precision = math.ceil(bit_precision / in_bits)
        self.bit_precision = self.word_precision * in_bits
        self.number_of_barriers = 1 + 2 * math.ceil(self.tail_bound * self.sigma)

        # precomputeBarrierValues() (:296-368): replay the reference's exact
        # MPFR op sequence — against libmpfr via ctypes where it loads, else
        # in the standard library with the same per-op rounding — so the
        # barriers are bit-identical (mpfr_barriers.py, anchored by the
        # golden interop vectors).
        from . import mpfr_barriers
        compute = (mpfr_barriers.compute_barriers
                   if mpfr_barriers.available()
                   else mpfr_barriers.compute_barriers_decimal)
        self.barriers = compute(self.sigma, self.center, self.rounded_center,
                                self.number_of_barriers, self.bit_precision)
        # value attached to the region below barrier 0
        self.base_value = self.rounded_center - (self.number_of_barriers - 1) // 2

        self._build_lookup_tables()
        # float32 arithmetic for buffer sizing, matching the reference (:488-496)
        lu = np.float32(self._lu_size)
        if lu_depth == 1:
            m = (np.float32(1.05) * ((lu - np.float32(self._flag_ctr1)) / lu)
                 + np.float32(self.word_precision)
                 * (np.float32(self._flag_ctr1) / lu))
        else:
            m = (np.float32(1.05) * ((lu - np.float32(self._flag_ctr1)) / lu)
                 + np.float32(2.0) * (np.float32(self._flag_ctr1) / lu)
                 + np.float32(self.word_precision)
                 * (np.float32(self._flag_ctr2) / (lu * lu)))
        self.innoise_multiplier = float(m)
        if verbose:
            print(f"FastGaussianNoise: {self.number_of_barriers} barriers, "
                  f"{self.bit_precision} bits of precision")

    # -- lookup construction (buildLookupTables, :374-475) -------------------
    def _word(self, barrier_int: int, j: int) -> int:
        """j-th most-significant in_class word of a barrier integer."""
        shift = self.bit_precision - (j + 1) * self.in_bits
        return (barrier_int >> shift) & (self._lu_size - 1)

    def _build_lookup_tables(self):
        nb = self.number_of_barriers
        size = self._lu_size
        self.lu_val = np.zeros(size, dtype=np.int64)
        self.lu_flag = np.zeros(size, dtype=bool)
        self.lu_barriers = [[] for _ in range(size)]  # depth-1 lists
        self.lu2 = {}  # first word -> (val[size], flag[size], barriers dict)
        self._flag_ctr1 = 0
        self._flag_ctr2 = 0

        val = self.base_value
        b_index = 0
        lu1 = 0
        while val <= self.base_value + nb - 1 and lu1 < size:
            while lu1 < self._word(self.barriers[b_index], 0) and lu1 < size:
                self.lu_val[lu1] = val
                lu1 += 1
            if lu1 >= size:
                break
            self.lu_val[lu1] = val
            self.lu_flag[lu1] = True
            self._flag_ctr1 += 1
            if self.lu_depth == 1:
                self.lu_barriers[lu1].append(b_index)
                b_index += 1
                val += 1
                while (b_index < nb
                       and lu1 == self._word(self.barriers[b_index], 0)):
                    self.lu_barriers[lu1].append(b_index)
                    b_index += 1
                    val += 1
            else:
                val2 = np.zeros(size, dtype=np.int64)
                flag2 = np.zeros(size, dtype=bool)
                bars2 = {}
                lu2 = 0
                while lu2 < size:
                    b0 = self._word(self.barriers[b_index], 0)
                    b1 = self._word(self.barriers[b_index], 1)
                    if lu1 < b0 or lu2 < b1:
                        val2[lu2] = val
                    elif lu1 == b0 and lu2 == b1:
                        val2[lu2] = val
                        flag2[lu2] = True
                        self._flag_ctr2 += 1
                        lst = [b_index]
                        b_index += 1
                        val += 1
                        while (b_index < nb
                               and lu1 == self._word(self.barriers[b_index], 0)
                               and lu2 == self._word(self.barriers[b_index], 1)):
                            lst.append(b_index)
                            b_index += 1
                            val += 1
                        bars2[lu2] = lst
                    lu2 += 1
                self.lu2[lu1] = (val2, flag2, bars2)
            lu1 += 1

        # big-endian word arrays of each barrier, for the cmp walk
        wp = self.word_precision
        self.barrier_words = np.zeros((nb, wp), dtype=np.uint16)
        for b in range(nb):
            for j in range(wp):
                self.barrier_words[b, j] = self._word(self.barriers[b], j)


    # -- host sampling: exact stream-consumption emulation (:478-595) --------
    def get_noise(self, stream: Salsa20Stream, rlen: int) -> np.ndarray:
        from .. import native
        if native.available():
            if not hasattr(self, "_native_tables"):
                self._native_tables = native.flatten_gaussian_tables(self)
            state = native.make_state(stream.key, stream.nonce)
            out = native.gaussian_noise(self, self._native_tables, state,
                                        rlen)
            stream.nonce = native.state_nonce(state)
            return out
        return self._get_noise_py(stream, rlen)

    def _get_noise_py(self, stream: Salsa20Stream, rlen: int) -> np.ndarray:
        wp = self.word_precision
        innoise_words = int(np.float32(rlen) * np.float32(self.innoise_multiplier))
        word_dtype = np.uint8 if self.in_bits == 8 else np.dtype("<u2")

        def fill():
            raw = stream.randombytes(innoise_words * (self.in_bits // 8))
            return np.frombuffer(raw, dtype=word_dtype).astype(np.int64)

        noise = fill()
        pos = 0
        used = 0
        out = np.empty(rlen, dtype=np.int64)
        computed = 0

        def cmp_barrier(b_idx: int, at: int) -> int:
            bw = self.barrier_words[b_idx]
            for j in range(wp):
                if bw[j] > noise[at + j]:
                    return 1
                if bw[j] < noise[at + j]:
                    return -1
            return 0

        while computed < rlen:
            w0 = int(noise[pos])
            if self.lu_flag[w0]:
                if self.lu_depth == 1:
                    output = int(self.lu_val[w0])
                    for b_idx in self.lu_barriers[w0]:
                        if cmp_barrier(b_idx, pos) == 1:
                            break
                        output += 1
                    pos += wp - 1
                    used += wp - 1
                else:
                    w1 = int(noise[pos + 1])
                    val2, flag2, bars2 = self.lu2[w0]
                    if flag2[w1]:
                        output = int(val2[w1])
                        for b_idx in bars2[w1]:
                            if cmp_barrier(b_idx, pos) == 1:
                                break
                            output += 1
                        pos += wp - 2
                        used += wp - 2
                    else:
                        output = int(val2[w1])
                    pos += 1
                    used += 1
            else:
                output = int(self.lu_val[w0])
            pos += 1
            used += 1
            out[computed] = output
            computed += 1
            if used + wp >= innoise_words:
                noise = fill()
                pos = 0
                used = 0
        return out

    # -- device-friendly sampling: fixed consumption, same distribution ------
    def noise_table(self):
        """(base_value, barriers[nb] as python ints) for searchsorted-style
        device sampling."""
        return self.base_value, list(self.barriers)

    def get_noise_fixed(self, randomness: np.ndarray) -> np.ndarray:
        """Branchless reference implementation of the fixed-consumption
        sampler: randomness [rlen, word_precision] big-endian words ->
        outputs [rlen].  (Host mirror of the device kernel.)"""
        wp = self.word_precision
        r = np.zeros(randomness.shape[0], dtype=object)
        for j in range(wp):
            r = (r << self.in_bits) | randomness[:, j].astype(object)
        bars = np.array(self.barriers, dtype=object)
        idx = np.searchsorted(bars, r, side="right")
        return (self.base_value + idx).astype(np.int64)
