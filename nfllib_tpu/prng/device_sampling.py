"""On-device polynomial samplers (jit-able, device-resident).

Device tier of the sampling subsystem (reference include/nfl/core.hpp:145-391
semantics): the Salsa20 keystream is generated on the accelerator
(salsa20.device_stream_words) and consumed entirely in-graph, so sampling
fuses with downstream NTT/modops without host transfers.

Byte-consumption contracts:
  * uniform / non_uniform / ZO reproduce the host tier EXACTLY for the same
    (key, nonce): same stream layout, same masking quirks, same values.
  * gaussian has two device formulations:
      - device_gaussian (default in the fused pipelines): fixed consumption
        (every sample eats word_precision big-endian words) — equal in
        DISTRIBUTION to the host walk but a different stream pattern;
      - device_gaussian_exact: STREAM-EXACT — bit-identical outputs to the
        host walk for the same (key, nonce), reproducing its variable
        per-sample consumption and refill policy by pointer doubling.
  * hwt_dist has the same two device formulations as the gaussian:
      - device_hwt (dispatcher default): fixed consumption (n + h words) —
        distribution-equal via argsort-of-random-keys subset selection;
      - device_hwt_exact: STREAM-EXACT — bit-identical to the host's
        sequential rejection reservoir (core.hpp:352-391) for the same
        (key, nonce), resolving the (astronomically rare) data-dependent
        rejections exactly.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ring import Ring
from .salsa20 import device_stream_words
from .sampling import ZO_dist, gaussian, hwt_dist, non_uniform, uniform


def _stream_bytes(key: bytes, nonce: int, nbytes: int):
    """[nbytes] uint8 keystream on device (little-endian word serialization,
    identical bytes to Salsa20Stream.randombytes)."""
    nblocks = (nbytes + 63) // 64
    words = device_stream_words(key, nonce, nblocks).reshape(-1)
    b0 = (words & 0xFF).astype(jnp.uint8)
    b1 = ((words >> 8) & 0xFF).astype(jnp.uint8)
    b2 = ((words >> 16) & 0xFF).astype(jnp.uint8)
    b3 = (words >> 24).astype(jnp.uint8)
    return jnp.stack([b0, b1, b2, b3], axis=-1).reshape(-1)[:nbytes]


def _stream_limbs(key: bytes, nonce: int, count: int, itemsize: int):
    """[count] little-endian unsigned integers of `itemsize` bytes."""
    nbytes = count * itemsize
    nblocks = (nbytes + 63) // 64
    words32 = device_stream_words(key, nonce, nblocks).reshape(-1)
    if itemsize == 2:
        lo = (words32 & 0xFFFF).astype(jnp.uint16)
        hi = (words32 >> 16).astype(jnp.uint16)
        return jnp.stack([lo, hi], axis=-1).reshape(-1)[:count]
    if itemsize == 4:
        return words32[:count]
    w = words32.astype(jnp.uint64)
    return (w[0::2] | (w[1::2] << 32))[:count]


def device_uniform(ring: Ring, key: bytes, nonce: int):
    """Uniform residues, bit-identical to sampling.sample_uniform
    (mask + single conditional subtract, core.hpp:151-186)."""
    lp = ring.limb_params
    total = ring.nmoduli * ring.degree
    vals = _stream_limbs(key, nonce, total, lp.itemsize)
    vals = vals.reshape(ring.nmoduli, ring.degree)
    mask = jnp.asarray((1 << lp.modulus_bits) - 1, dtype=lp.dtype)
    p_col = jnp.asarray(np.array(ring.moduli, dtype=lp.dtype).reshape(-1, 1))
    t = vals & mask
    return jnp.where(t >= p_col, t - p_col, t)


def device_non_uniform(ring: Ring, key: bytes, nonce: int, mode: non_uniform):
    """Bounded centered noise, bit-identical to sampling.sample_non_uniform
    (core.hpp:194-282: wrapping value_type arithmetic, negatives as p + v)."""
    lp = ring.limb_params
    ub = int(mode.upper_bound)
    amp = int(mode.amplifier)
    for p in ring.moduli:
        if ub >= p:
            raise ValueError("upper_bound is larger than the modulus")
    rnd = _stream_limbs(key, nonce, ring.degree, lp.itemsize)
    span = 2 * ub - 1
    mask = jnp.asarray((1 << span.bit_length()) - 1, dtype=lp.dtype)
    t = (rnd & mask).astype(jnp.uint64)
    t = jnp.where(t >= span, t - span, t)
    neg = t >= ub
    p_col = jnp.asarray(np.array([int(p) for p in ring.moduli],
                                 dtype=np.uint64).reshape(-1, 1))
    vals = jnp.where(neg[None, :], p_col + t[None, :] * amp - span * amp,
                     t[None, :] * amp)
    repr_mask = jnp.asarray((1 << lp.repr_bits) - 1, dtype=jnp.uint64)
    return (vals & repr_mask).astype(lp.dtype)


def device_zo(ring: Ring, key: bytes, nonce: int, mode: ZO_dist):
    """Ternary sampler, bit-identical to sampling.sample_zo including the
    non-canonical p+1 encoding of +1 (core.hpp:333-344)."""
    lp = ring.limb_params
    rnd = _stream_bytes(key, nonce, ring.degree)
    hit = rnd <= jnp.uint8(mode.rho)
    bit = (rnd & 2).astype(jnp.uint64)
    p_col = jnp.asarray(np.array([int(p) - 1 for p in ring.moduli],
                                 dtype=np.uint64).reshape(-1, 1))
    vals = jnp.where(hit[None, :], p_col + bit[None, :],
                     jnp.zeros_like(p_col))
    mask = jnp.asarray((1 << lp.repr_bits) - 1, dtype=jnp.uint64)
    return (vals & mask).astype(lp.dtype)


def device_gaussian(ring: Ring, key: bytes, nonce: int, mode: gaussian):
    """Fixed-consumption discrete Gaussian: degree * word_precision big-endian
    stream words per call; output = base_value + #{barriers <= r}, encoded
    per channel as p + v for negative v (core.hpp:306-316).

    #{barriers <= r} is computed searchsorted-style: the barriers are sorted
    (cumulative CDF values), so a branchless per-sample binary search needs
    only ceil(log2(nb+1)) gathered wp-word lexicographic compares —
    O(wp*log nb) per sample instead of the dense O(wp*nb), so cost grows
    logarithmically with sigma (nb ~ 2*ceil(t*sigma)) instead of linearly.
    (A 16-bit prefix table was tried and rejected: tail barriers cluster
    within 2^-16 of 0 and 1, so prefixes collide en masse.)"""
    fg = mode.fg_prng
    amp = int(mode.amplifier)
    wp = fg.word_precision
    n = ring.degree
    if fg.in_bits == 8:
        raw = _stream_bytes(key, nonce, n * wp).reshape(n, wp)
    else:  # in_bits == 16: little-endian 16-bit stream limbs per word
        raw = _stream_limbs(key, nonce, n * wp, 2).reshape(n, wp)

    bw = np.asarray(fg.barrier_words)                      # [nb, wp]
    nb = bw.shape[0]
    r16 = raw.astype(jnp.int32)                            # [n, wp]
    bw_dev = jnp.asarray(bw.astype(np.int32))              # [nb, wp]

    # invariants: barriers[:lo] <= r, barriers[hi:] > r; count = final lo
    lo = jnp.zeros((n,), dtype=jnp.int32)
    hi = jnp.full((n,), nb, dtype=jnp.int32)
    for _ in range(max(1, (nb + 1).bit_length())):
        valid = lo < hi
        mid = (lo + hi) >> 1
        rows = jnp.take(bw_dev, mid, axis=0)               # [n, wp]
        # sign of (r - barrier[mid]) at the first differing word
        acc = jnp.zeros((n,), dtype=jnp.int8)
        for j in range(wp):
            s = jnp.sign(r16[:, j] - rows[:, j]).astype(jnp.int8)
            acc = jnp.where(acc != 0, acc, s)
        le = acc >= 0                                      # barrier[mid] <= r
        lo = jnp.where(valid & le, mid + 1, lo)
        hi = jnp.where(valid & ~le, mid, hi)
    noise = (fg.base_value + lo).astype(jnp.int64) * amp

    p_col = jnp.asarray(np.array([int(p) for p in ring.moduli],
                                 dtype=np.int64).reshape(-1, 1))
    vals = jnp.where(noise[None, :] < 0, p_col + noise[None, :],
                     noise[None, :])
    return vals.astype(ring.dtype)


def device_sample(ring: Ring, mode, key: bytes, nonce: int):
    """Dispatcher mirroring sampling.sample for the device tier."""
    if isinstance(mode, uniform):
        return device_uniform(ring, key, nonce)
    if isinstance(mode, non_uniform):
        return device_non_uniform(ring, key, nonce, mode)
    if isinstance(mode, ZO_dist):
        return device_zo(ring, key, nonce, mode)
    if isinstance(mode, gaussian):
        return device_gaussian(ring, key, nonce, mode)
    if isinstance(mode, hwt_dist):
        return device_hwt(ring, key, nonce, mode)
    raise TypeError(f"no device tier for sampler mode {mode!r}")


# ---------------------------------------------------------------------------
# stream-exact device Gaussian (the host walk's variable consumption,
# parallelized by pointer doubling) and device hwt_dist
# ---------------------------------------------------------------------------

def _count_barriers_le(r16, bw_dev, nb):
    """#{barriers <= r} per sample via branchless binary search over the
    sorted barrier table.  r16: [s, wp] int32 big-endian words; bw_dev:
    [nb, wp] int32."""
    s, wp = r16.shape
    lo = jnp.zeros((s,), dtype=jnp.int32)
    hi = jnp.full((s,), nb, dtype=jnp.int32)
    for _ in range(max(1, (nb + 1).bit_length())):
        valid = lo < hi
        mid = (lo + hi) >> 1
        rows = jnp.take(bw_dev, mid, axis=0)
        acc = jnp.zeros((s,), dtype=jnp.int8)
        for j in range(wp):
            sg = jnp.sign(r16[:, j] - rows[:, j]).astype(jnp.int8)
            acc = jnp.where(acc != 0, acc, sg)
        le = acc >= 0
        lo = jnp.where(valid & le, mid + 1, lo)
        hi = jnp.where(valid & ~le, mid, hi)
    return lo


def device_gaussian_exact(ring: Ring, key: bytes, nonce, mode: gaussian,
                          return_fills: bool = False):
    """STREAM-EXACT device Gaussian: same (key, nonce) => bit-identical
    outputs to the host walk (prng/gaussian.py _get_noise_py, reference
    FastGaussianNoise.hpp:478-595), including its data-dependent per-sample
    word consumption (1, 2 or word_precision words) and its
    refill-and-discard block policy.

    The host walk is sequential; here it parallelizes by POINTER DOUBLING:
    the per-position consumption c(q) depends only on the one or two words
    at q, so the successor map g(q) = q + c(q) (with an absorbing sentinel
    at the refill boundary) is a precomputable table per refill block, and
    the sample-start positions are g's orbit of 0 — computed for all blocks
    at once in ceil(log2(block_size)) gather rounds instead of one step per
    sample.  Outputs are then a vectorized table/binary-search evaluation
    at the start positions, exactly as the host short-circuits them.

    `nonce` may be a python int or a traced scalar (device_stream_words
    accepts both), and `return_fills=True` additionally returns the number
    of fill() calls the host walk would have made — i.e. how far the host
    stream's nonce advances — so multiple exact samplers can CHAIN with
    bit-identical results to sequential host draws (apps/lwe.py's exact
    on-device pipeline)."""
    fg = mode.fg_prng
    amp = int(mode.amplifier)
    wp = fg.word_precision
    rlen = ring.degree
    innoise = int(np.float32(rlen) * np.float32(fg.innoise_multiplier))
    # static block budget: each refill block yields at least
    # floor((innoise - wp)/wp) samples (worst case wp words per sample)
    s_min = max(1, (innoise - wp) // wp)
    nblocks = -(-rlen // s_min)
    ib = fg.in_bits
    L = 1 << ib

    # one keystream CALL per refill block, exactly like the host walk:
    # Salsa20Stream.randombytes bumps the nonce once per call (the
    # reference fastrandombytes quirk), so fill k reads the start of the
    # (nonce + k) stream — blocks are NOT contiguous keystream bytes.
    # One Salsa20 graph vmapped over the fills (an unrolled loop per fill
    # multiplied the compile time by nblocks).
    fill_nonces = (jnp.asarray(nonce).astype(jnp.uint64)
                   + jnp.arange(nblocks, dtype=jnp.uint64))
    if ib == 8:
        words = jax.vmap(lambda nc: _stream_bytes(key, nc, innoise))(
            fill_nonces)
    else:
        words = jax.vmap(lambda nc: _stream_limbs(key, nc, innoise, 2))(
            fill_nonces)
    words = words.astype(jnp.int32)                     # [nblocks, innoise]

    # per-position consumption -> successor table with sentinel = innoise
    luf = jnp.asarray(fg.lu_flag)
    luv = jnp.asarray(fg.lu_val.astype(np.int32))
    w0 = words
    fl0 = jnp.take(luf, w0)
    if fg.lu_depth == 1:
        c = jnp.where(fl0, wp, 1).astype(jnp.int32)
    else:
        # compact second-level tables: lu2 has entries only for FLAGGED
        # first words (a dense [L, L] table would be 2^32 entries at
        # in_bits=16); slot0 maps w0 -> compact row, row 0 is a dummy
        flagged = [v0 for v0 in range(L) if fg.lu_flag[v0]]
        V2 = np.zeros((len(flagged) + 1, L), dtype=np.int32)
        F2 = np.zeros((len(flagged) + 1, L), dtype=bool)
        slot = np.zeros(L, dtype=np.int32)
        for i, v0 in enumerate(flagged):
            val2, flag2, _ = fg.lu2[v0]
            V2[i + 1] = val2
            F2[i + 1] = flag2
            slot[v0] = i + 1
        V2d, F2d = jnp.asarray(V2), jnp.asarray(F2)
        slot_d = jnp.asarray(slot)
        w1 = jnp.roll(words, -1, axis=1)      # w1 at q = words[q+1]
        f2 = F2d[jnp.take(slot_d, w0), w1]
        c = jnp.where(~fl0, 1, jnp.where(f2, wp, 2)).astype(jnp.int32)
    nxt = jax.lax.broadcasted_iota(jnp.int32, (nblocks, innoise), 1) + c
    g = jnp.where(nxt + wp >= innoise, innoise, nxt)
    g = jnp.concatenate([g, jnp.full((nblocks, 1), innoise, jnp.int32)],
                        axis=1)               # absorbing sentinel column

    # orbit of 0 under g, all blocks at once, by doubling
    pos = jnp.zeros((nblocks, 1), dtype=jnp.int32)
    F = g
    jmax = min(innoise, rlen)                 # c >= 1 per sample
    while pos.shape[1] < jmax:
        pos = jnp.concatenate(
            [pos, jnp.take_along_axis(F, pos, axis=1)], axis=1)
        if pos.shape[1] < jmax:
            F = jnp.take_along_axis(F, F, axis=1)
    valid = pos < innoise                     # [nblocks, jmax]

    # outputs at every candidate start position (vectorized)
    qs = jnp.minimum(pos, innoise - wp)       # clamp sentinel reads
    w0s = jnp.take_along_axis(words, qs, axis=1)
    fl0s = jnp.take(luf, w0s)
    base = jnp.take(luv, w0s)                 # lu_val[w0]
    rwords = jnp.stack(
        [jnp.take_along_axis(words, qs + j, axis=1) for j in range(wp)],
        axis=-1)                              # [nblocks, jmax, wp]
    bw = np.asarray(fg.barrier_words).astype(np.int32)
    cnt = _count_barriers_le(rwords.reshape(-1, wp), jnp.asarray(bw),
                             bw.shape[0]).reshape(w0s.shape)
    full = jnp.int32(fg.base_value) + cnt     # full-precision cmp result
    if fg.lu_depth == 1:
        out = jnp.where(fl0s, full, base)
    else:
        w1s = jnp.take_along_axis(words, qs + 1, axis=1)
        s0 = jnp.take(slot_d, w0s)
        f2s = F2d[s0, w1s]
        v2s = V2d[s0, w1s]
        out = jnp.where(~fl0s, base, jnp.where(f2s, full, v2s))

    # first rlen valid samples in block-major order
    flat_valid = valid.reshape(-1)
    flat_out = out.reshape(-1).astype(jnp.int64) * amp
    idx = jnp.cumsum(flat_valid.astype(jnp.int32)) - 1
    selected = flat_valid & (idx < rlen)
    tgt = jnp.where(selected, idx, rlen)
    noise = jnp.zeros((rlen,), dtype=jnp.int64).at[tgt].set(
        flat_out, mode="drop")

    p_col = jnp.asarray(np.array([int(p) for p in ring.moduli],
                                 dtype=np.int64).reshape(-1, 1))
    vals = jnp.where(noise[None, :] < 0, p_col + noise[None, :],
                     noise[None, :])
    vals = vals.astype(ring.dtype)
    if not return_fills:
        return vals
    # fills the HOST would make: the initial one plus one refill per
    # selected sample whose successor hits the sentinel (the host refills
    # inside the loop body, even after the final sample)
    succ = jnp.take_along_axis(g, jnp.minimum(pos, innoise), axis=1)
    trip = (succ == innoise).reshape(-1)
    fills = 1 + jnp.sum(jnp.where(selected & trip, 1, 0))
    return vals, fills


def _hwt_positions_from_words(W, n: int, h: int, amb_cap: int):
    """Core of the stream-exact hwt walk: given the budgeted reservoir word
    stream W ([Wtot] uint64, consumption order), reproduce the host
    rejection-sampled reservoir (sampling.sample_hwt, reference
    core.hpp:352-391) exactly and return (order, fills_res):
      order     [h] int32 — the sorted final reservoir (hit positions),
      fills_res scalar    — how many h-word fill() calls the host consumed.

    The host walk is sequential (for k in h..n-1: pop words until one is
    accepted), but its data dependence is almost degenerate: every pop
    consumes exactly ONE word, and a word can only be REJECTED when
    w > M - (M mod k) with (M mod k) < k <= n — i.e. when w lands in the
    top < n values of the 2^64 range (probability < 2^-44 per word).  So:
      * words with w <= M - n are accepted at ANY k: if none of the tiny
        "ambiguous" tail set occurs (the overwhelmingly common case) the
        k-counter at word i is simply h + i and everything vectorizes;
      * the at-most-a-handful ambiguous words are resolved exactly, in
        order, by a fori_loop of `amb_cap` O(1) steps (each rejection
        shifts every later word's k down by one).
    This is the hwt analog of the gaussian sampler's pointer-doubling: the
    sequential state (here the k counter) is recovered from per-word local
    data plus a vanishing number of data-dependent fixups.

    Also returns `ok`, a traced bool that is False when either budget
    assumption is exceeded — more than `amb_cap` ambiguous words, or fewer
    than n-h accepted words in the budgeted stream (each has probability
    ~2^-44 per word) — so callers can poison the output instead of
    silently diverging from the host stream."""
    import jax.numpy as _jnp
    from jax import lax

    Wtot = int(W.shape[0])
    M = _jnp.uint64(0xFFFFFFFFFFFFFFFF)
    # superset of every possibly-rejectable word: rejection needs
    # w > M - (M mod k) >= M - (n - 2)
    amb = W > (M - _jnp.uint64(n))
    amb_count = _jnp.sum(amb.astype(_jnp.int32))
    iota = _jnp.arange(Wtot, dtype=_jnp.int32)
    big = _jnp.int32(Wtot)
    amb_idx = _jnp.sort(_jnp.where(amb, iota, big))[:amb_cap]

    def body(j, carry):
        rejected, rejcount = carry
        i = amb_idx[j]
        valid = i < big
        ic = _jnp.minimum(i, big - 1)
        w = W[ic]
        # k at word i = h + #accepts before i = h + i - #rejects before i;
        # all rejected words are ambiguous, so rejcount IS that count
        k = _jnp.uint64(h) + ic.astype(_jnp.uint64) - rejcount
        kc = _jnp.clip(k, _jnp.uint64(1), _jnp.uint64(max(n - 1, 1)))
        rej = valid & (w > (M - (M % kc)))
        rejected = rejected.at[i].set(rej, mode="drop")
        return rejected, rejcount + rej.astype(_jnp.uint64)

    rejected = _jnp.zeros((Wtot,), dtype=bool)
    rejected, _ = lax.fori_loop(
        0, amb_cap, body, (rejected, _jnp.uint64(0)))
    accepted = ~rejected
    acc = accepted.astype(_jnp.int32)
    acc_excl = _jnp.cumsum(acc) - acc                 # #accepts before i
    k = _jnp.uint64(h) + acc_excl.astype(_jnp.uint64)
    consumed = acc_excl < (n - h)                     # popped by the host
    upd = consumed & accepted
    pos = (W % _jnp.maximum(k, _jnp.uint64(1))).astype(_jnp.int32)
    write = upd & (pos < h)
    tgt = _jnp.where(write, pos, h)                   # h = drop slot
    # hitted[p] = k of the LAST write to slot p (k strictly increases over
    # accepted words, so last == max), else its initial value p
    vals = _jnp.full((h,), -1, dtype=_jnp.int32).at[tgt].max(
        k.astype(_jnp.int32), mode="drop")
    hitted = _jnp.where(vals >= 0, vals, _jnp.arange(h, dtype=_jnp.int32))
    order = _jnp.sort(hitted)
    T = _jnp.sum(consumed.astype(_jnp.int32))         # words popped
    fills_res = (T + h - 1) // h                      # ceil: refill-on-empty
    # budget guard: the walk above is only exact when the
    # ambiguous set fit amb_cap and the budgeted stream held n-h accepts
    n_accepted = _jnp.sum(acc)
    ok = (amb_count <= _jnp.int32(amb_cap)) & \
        (n_accepted >= _jnp.int32(n - h))
    return order, fills_res, ok


def device_hwt_exact(ring: Ring, key: bytes, nonce, mode,
                     return_fills: bool = False, _amb_cap: int = 8):
    """STREAM-EXACT device hwt_dist: same (key, nonce) => bit-identical
    output to the host walk (sampling.sample_hwt, reference
    core.hpp:352-391), including its variable rejection-loop word
    consumption and refill-on-empty policy (see _hwt_positions_from_words).

    Like the host, fill f reads the first h*8 bytes of the (nonce + f)
    stream (the Salsa20Stream per-call nonce bump), and the h sign words
    come from one more call AFTER the reservoir finishes — at a
    data-dependent nonce offset, handled by device_stream_words' traced
    nonce support.  `return_fills=True` additionally returns the total
    nonce advance (reservoir fills + the sign call) so exact samplers can
    chain bit-identically to sequential host draws."""
    h = int(mode.hwt)
    n = ring.degree
    if not 0 < h <= n:
        raise ValueError("hwt must be in (0, degree]")
    # zero-rejection consumption is n - h words; ONE spare fill of h words
    # absorbs any realistic rejection count (each rejection costs one extra
    # word and happens with probability < n/2^64 < 2^-44 per word)
    nf_budget = max(1, -(-(n - h) // h) + 1)
    fills = [_stream_limbs(key, nonce + f, h, 8) for f in range(nf_budget)]
    W = jnp.concatenate(fills)
    order, fills_res, ok = _hwt_positions_from_words(W, n, h, _amb_cap)

    signs = _stream_limbs(key, nonce + fills_res, h, 8)
    bit = signs & jnp.uint64(2)                       # j-th word, j-th hit
    hit = jnp.zeros((n,), dtype=bool).at[order].set(True)
    bitarr = jnp.zeros((n,), dtype=jnp.uint64).at[order].set(bit)
    lp = ring.limb_params
    p_col = jnp.asarray(np.array([int(p) - 1 for p in ring.moduli],
                                 dtype=np.uint64).reshape(-1, 1))
    vals = jnp.where(hit[None, :], p_col + bitarr[None, :],
                     jnp.zeros_like(p_col))
    mask = jnp.asarray((1 << lp.repr_bits) - 1, dtype=jnp.uint64)
    out = (vals & mask).astype(lp.dtype)
    # budget guard: if the walk's assumptions were
    # exceeded (probability ~2^-44 per word), poison every residue with the
    # out-of-range sentinel `mask` (>= p, fails any strict-mod/range check)
    # and report fills -1 — loud, detectable divergence instead of silent
    out = jnp.where(ok, out, jnp.full_like(out, mask.astype(lp.dtype)))
    if not return_fills:
        return out
    return out, jnp.where(ok, fills_res + 1, -1)


def device_hwt(ring: Ring, key: bytes, nonce: int, mode):
    """Exact-Hamming-weight +-1 polynomial on device (reference
    core.hpp:352-391 semantics: h positions hit, signs from bit 1 of one
    64-bit word per hit, negatives encoded as p - 1).

    Fixed-consumption formulation (the dispatcher default; see
    device_hwt_exact for the stream-exact tier): the h-subset comes from a
    random-key argsort (top-h of n 64-bit keys = a uniform h-subset, key
    collisions ~ n^2/2^64), consuming n + h words instead of the host's
    variable count — distribution-equal, not stream-exact."""
    h = int(mode.hwt)
    n = ring.degree
    if not 0 < h <= n:
        raise ValueError("hwt must be in (0, degree]")
    keys64 = _stream_limbs(key, nonce, n + h, 8)
    order = jnp.argsort(keys64[:n])
    hit_positions = order[:h]
    hit = jnp.zeros((n,), dtype=bool).at[hit_positions].set(True)
    # signs: one word per hit, assigned in ascending position order like
    # the host (hitted.sort() before the sign draw)
    rank = jnp.cumsum(hit.astype(jnp.int32)) - 1      # position -> j
    signs = keys64[n:]
    bit = jnp.where(hit, (jnp.take(signs, jnp.clip(rank, 0, h - 1))
                          & jnp.uint64(2)).astype(jnp.uint64),
                    jnp.uint64(0))
    lp = ring.limb_params
    p_col = jnp.asarray(np.array([int(p) - 1 for p in ring.moduli],
                                 dtype=np.uint64).reshape(-1, 1))
    vals = jnp.where(hit[None, :], p_col + bit[None, :],
                     jnp.zeros_like(p_col))
    mask = jnp.asarray((1 << lp.repr_bits) - 1, dtype=jnp.uint64)
    return (vals & mask).astype(lp.dtype)
