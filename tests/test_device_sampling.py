"""Device-tier samplers vs the host tier.

uniform / non_uniform / ZO must be bit-identical to the host samplers for the
same (key, nonce); gaussian uses the fixed-consumption formulation and is
checked against its host mirror (get_noise_fixed) on the same keystream, plus
a moments check.
"""
import numpy as np
import pytest

import nfllib_tpu as nfl
from nfllib_tpu.prng import device_sampling as dev
from nfllib_tpu.prng import sampling
from nfllib_tpu.prng.gaussian import FastGaussianNoise
from nfllib_tpu.prng.salsa20 import Salsa20Stream

from conftest import make_ring

KEY = b"\x5A" * 32

CONFIGS = [
    (128, 14, "u16"),
    (256, 60, "u32"),
    (64, 124, "u64"),
]


@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
def test_device_uniform_matches_host(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    want = sampling.sample_uniform(ring, Salsa20Stream(KEY, nonce=3))
    got = np.asarray(dev.device_uniform(ring, KEY, 3))
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
def test_device_non_uniform_matches_host(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    mode = sampling.non_uniform(7, 2)
    want = sampling.sample_non_uniform(ring, Salsa20Stream(KEY), mode)
    got = np.asarray(dev.device_non_uniform(ring, KEY, 0, mode))
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
def test_device_zo_matches_host(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    mode = sampling.ZO_dist(0x7F)
    want = sampling.sample_zo(ring, Salsa20Stream(KEY, nonce=9), mode)
    got = np.asarray(dev.device_zo(ring, KEY, 9, mode))
    np.testing.assert_array_equal(want, got)


@pytest.fixture(scope="module")
def fg():
    return FastGaussianNoise(4.0, 128, 1 << 10)


def test_device_gaussian_matches_fixed_host_mirror(fg):
    ring = make_ring(256, 60, "u32")
    n, wp = ring.degree, fg.word_precision
    raw = np.frombuffer(Salsa20Stream(KEY, nonce=5).randombytes(n * wp),
                        dtype=np.uint8).reshape(n, wp).astype(np.uint16)
    want_noise = fg.get_noise_fixed(raw)
    got = np.asarray(dev.device_gaussian(ring, KEY, 5, sampling.gaussian(fg)))
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        want = np.where(want_noise < 0, p + want_noise, want_noise)
        np.testing.assert_array_equal(got[cm].astype(np.int64), want)


@pytest.mark.parametrize("sigma", [20.0, 80.0])
def test_device_gaussian_large_sigma_matches_mirror(sigma):
    """Wide Gaussians have many more barriers (nb ~ 2*ceil(t*sigma)) and
    exercise deeper binary searches (incl. heavily-clustered tail barriers
    that differ only in deep words); outputs must equal the exact host
    mirror."""
    fg = FastGaussianNoise(sigma, 128, 1 << 10)
    ring = make_ring(512, 60, "u32")
    n, wp = ring.degree, fg.word_precision
    raw = np.frombuffer(Salsa20Stream(KEY, nonce=9).randombytes(n * wp),
                        dtype=np.uint8).reshape(n, wp).astype(np.uint16)
    want_noise = fg.get_noise_fixed(raw)
    got = np.asarray(dev.device_gaussian(ring, KEY, 9, sampling.gaussian(fg)))
    p = int(ring.moduli[0])
    want = np.where(want_noise < 0, p + want_noise, want_noise)
    np.testing.assert_array_equal(got[0].astype(np.int64), want)


def test_device_gaussian_in_bits_16_matches_mirror():
    """The 16-bit word flavor (reference FastGaussianNoise in_bits=16)
    consumes little-endian 16-bit stream limbs and must equal the exact
    host mirror on the same words."""
    fg16 = FastGaussianNoise(4.0, 128, 1 << 10, in_bits=16)
    ring = make_ring(256, 60, "u32")
    n, wp = ring.degree, fg16.word_precision
    raw = np.frombuffer(Salsa20Stream(KEY, nonce=3).randombytes(n * wp * 2),
                        dtype="<u2").reshape(n, wp)
    want_noise = fg16.get_noise_fixed(raw)
    got = np.asarray(dev.device_gaussian(ring, KEY, 3,
                                         sampling.gaussian(fg16)))
    p = int(ring.moduli[0])
    want = np.where(want_noise < 0, p + want_noise, want_noise)
    np.testing.assert_array_equal(got[0].astype(np.int64), want)


def test_device_gaussian_moments(fg):
    ring = make_ring(8192, 60, "u32")
    got = np.asarray(dev.device_gaussian(ring, KEY, 11,
                                         sampling.gaussian(fg)))
    p0 = int(ring.moduli[0])
    signed = got[0].astype(np.int64)
    signed = np.where(signed > p0 // 2, signed - p0, signed)
    assert abs(signed.mean()) < 0.3
    assert abs(signed.std() - 4.0) < 0.3
    assert np.all(np.abs(signed) <= 6 * 4 + 1)


def test_poly_sample_on_device(fg):
    ring = make_ring(256, 60, "u32")
    a = nfl.Poly.sample_on_device(ring, nfl.uniform(), KEY, 1)
    b = nfl.Poly.sample(ring, nfl.uniform(), Salsa20Stream(KEY, nonce=1))
    assert a == b


# ---------------------------------------------------------------------------
# stream-exact device Gaussian + device hwt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(sigma=20.0, security=128, samples=256, in_bits=8, lu_depth=2),
    dict(sigma=3.2, security=80, samples=256, in_bits=8, lu_depth=1),
    dict(sigma=20.0, security=128, samples=256, in_bits=16, lu_depth=2),
])
def test_device_gaussian_exact_matches_host_walk(cfg):
    """device_gaussian_exact is bit-identical to the host walk (the
    reference's FastGaussianNoise.hpp:478-595 semantics) for the same
    (key, nonce), across lu depths and both in_bits flavors."""
    from nfllib_tpu.prng.gaussian import FastGaussianNoise
    from nfllib_tpu.prng import sampling

    fg = FastGaussianNoise(**cfg)
    ring = nfl.Ring("u32", 256, 2)
    for nonce in (0, 5):
        for ampl in (1, 2):
            mode = sampling.gaussian(fg, ampl)
            st = Salsa20Stream(KEY)
            st.nonce = nonce
            want = sampling.sample_gaussian(ring, st, mode)
            got = np.asarray(
                dev.device_gaussian_exact(ring, KEY, nonce, mode))
            np.testing.assert_array_equal(got, want)


def test_device_gaussian_exact_refill_crossing():
    """The exact walk reproduces the host's refill policy (each fill is a
    fresh nonce; leftover words discarded) across multiple refills."""
    from nfllib_tpu.prng.gaussian import FastGaussianNoise
    from nfllib_tpu.prng import sampling

    fg = FastGaussianNoise(sigma=250.0, security=128, samples=2048)
    ring = nfl.Ring("u64", 2048, 2)
    mode = sampling.gaussian(fg, 2)
    st = Salsa20Stream(KEY)
    want = sampling.sample_gaussian(ring, st, mode)
    got = np.asarray(dev.device_gaussian_exact(ring, KEY, 0, mode))
    np.testing.assert_array_equal(got, want)


def test_device_hwt_structure():
    """device_hwt: exactly h hits, reference encoding (+1 as the
    non-canonical p+1, -1 as p-1, core.hpp:352-391), consistent positions
    and signs across channels, nonce-sensitive."""
    from nfllib_tpu.prng.sampling import hwt_dist

    ring = nfl.Ring("u32", 512, 2)
    h = 64
    got = np.asarray(dev.device_hwt(ring, KEY, 0, hwt_dist(h)))
    for cm in range(2):
        p = int(ring.moduli[cm])
        nz = got[cm][got[cm] != 0]
        assert len(nz) == h
        assert set(int(v) for v in nz) <= {p - 1, p + 1}
    pos0 = np.nonzero(got[0])[0]
    pos1 = np.nonzero(got[1])[0]
    np.testing.assert_array_equal(pos0, pos1)
    p0, p1 = int(ring.moduli[0]), int(ring.moduli[1])
    np.testing.assert_array_equal(got[0][pos0] == p0 + 1,
                                  got[1][pos1] == p1 + 1)
    got2 = np.asarray(dev.device_hwt(ring, KEY, 1, hwt_dist(h)))
    assert not np.array_equal(got, got2)
    # dispatcher routes hwt to the device tier now
    got3 = np.asarray(dev.device_sample(ring, hwt_dist(h), KEY, 0))
    np.testing.assert_array_equal(got3, got)


def test_device_hwt_subset_uniformity():
    """Coarse acceptance: across many nonces every position is hit with
    frequency ~ h/n (chi-square-ish bound)."""
    from nfllib_tpu.prng.sampling import hwt_dist

    ring = nfl.Ring("u32", 64, 1)
    h = 8
    trials = 200
    counts = np.zeros(64)
    for nonce in range(trials):
        got = np.asarray(dev.device_hwt(ring, KEY, nonce, hwt_dist(h)))
        counts += got[0] != 0
    expected = trials * h / 64
    sd = np.sqrt(trials * (h / 64) * (1 - h / 64))
    assert np.all(np.abs(counts - expected) < 6 * sd), counts


# ---------------------------------------------------------------------------
# stream-exact device hwt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
@pytest.mark.parametrize("hfrac", ["one", "quarter", "full"])
def test_device_hwt_exact_matches_host(degree, agg, limb, hfrac):
    """Same (key, nonce) => byte-identical output to the host reservoir."""
    from nfllib_tpu.prng.sampling import hwt_dist

    ring = make_ring(degree, agg, limb)
    h = {"one": 1, "quarter": degree // 4, "full": degree}[hfrac]
    mode = hwt_dist(h)
    for nonce in (0, 5):
        want = sampling.sample_hwt(ring, Salsa20Stream(KEY, nonce=nonce),
                                   mode)
        got = np.asarray(dev.device_hwt_exact(ring, KEY, nonce, mode))
        np.testing.assert_array_equal(got, want)


def test_device_hwt_exact_chains_like_host():
    """return_fills lets consecutive exact draws mirror one host stream."""
    from nfllib_tpu.prng.sampling import hwt_dist

    ring = make_ring(256, 60, "u32")
    mode = hwt_dist(32)
    st = Salsa20Stream(KEY, nonce=2)
    want1 = sampling.sample_hwt(ring, st, mode)
    want2 = sampling.sample_hwt(ring, st, mode)
    got1, adv1 = dev.device_hwt_exact(ring, KEY, 2, mode, return_fills=True)
    got2 = dev.device_hwt_exact(ring, KEY, 2 + int(adv1), mode)
    np.testing.assert_array_equal(np.asarray(got1), want1)
    np.testing.assert_array_equal(np.asarray(got2), want2)
    assert int(adv1) == (st.nonce - 2) // 2  # each draw advances equally


def _host_walk_on_words(words, n, h):
    """Python mirror of sampling.sample_hwt's reservoir on a given word
    stream (fills of h words are just consecutive h-slices here)."""
    M = (1 << 64) - 1
    hitted = list(range(h))
    consumed = 0
    it = iter(words)
    for k in range(h, n):
        while True:
            w = int(next(it))
            consumed += 1
            if w <= (M // k) * k:
                pos = w % k
                break
        if pos < h:
            hitted[pos] = k
    hitted.sort()
    return hitted, -(-consumed // h)


def test_hwt_word_core_resolves_rejections():
    """_hwt_positions_from_words handles the data-dependent rejection path
    exactly: synthetic streams salted with near-2^64 words (impossible to
    hit through real Salsa20 output in a test) must reproduce the host
    walk's reservoir AND its fill count."""
    rng = np.random.default_rng(42)
    n, h = 96, 16
    M = (1 << 64) - 1
    for trial in range(20):
        budget = n  # plenty: n - h needed + rejections
        words = rng.integers(0, 1 << 63, size=budget, dtype=np.uint64) * 2 \
            + rng.integers(0, 2, size=budget, dtype=np.uint64)
        # salt 0..6 ambiguous words into the consumed prefix; values in
        # (M - n, M] — some reject (w > M - (M mod k)), some accept
        namb = int(rng.integers(0, 7))
        slots = rng.choice(n - h, size=namb, replace=False)
        words[slots] = M - rng.integers(0, n, size=namb, dtype=np.uint64)
        want_hitted, want_fills = _host_walk_on_words(words, n, h)
        import jax.numpy as jnp
        order, fills, ok = dev._hwt_positions_from_words(
            jnp.asarray(words), n, h, amb_cap=budget)
        np.testing.assert_array_equal(np.asarray(order), want_hitted)
        assert int(fills) == want_fills, trial
        assert bool(ok), trial


def test_hwt_word_core_budget_guard():
    """The ok flag trips when either exactness assumption
    breaks: more ambiguous words than amb_cap, or fewer accepted words than
    the reservoir needs — instead of silently diverging."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    n, h = 96, 16
    M = np.uint64((1 << 64) - 1)
    words = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    # 5 ambiguous words but amb_cap=3 -> not exactly resolvable
    words[:5] = M - np.uint64(1)
    _, _, ok = dev._hwt_positions_from_words(jnp.asarray(words), n, h,
                                             amb_cap=3)
    assert not bool(ok)
    # every word rejects at every k (w == M > M - (M mod k) whenever
    # k does not divide 2^64, true for all 1 < k < n): no accepts at all
    words_all_rej = np.full(n, M, dtype=np.uint64)
    _, _, ok2 = dev._hwt_positions_from_words(jnp.asarray(words_all_rej),
                                              n, h, amb_cap=n)
    assert not bool(ok2)
