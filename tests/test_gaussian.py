"""Discrete Gaussian sampler (FastGaussianNoise equivalent) tests.

Statistical checks mirror the reference's harness (tests/prng_demo_main.cpp
and the UNITTEST_ONEMILLION 6-sigma check, FastGaussianNoise.hpp:572-580);
the fixed-consumption device formulation is checked for distributional
equivalence against the exact stream-consumption emulation.
"""
import numpy as np
import pytest

from nfllib_tpu.prng.gaussian import FastGaussianNoise
from nfllib_tpu.prng.salsa20 import Salsa20Stream

import nfllib_tpu as nfl


@pytest.fixture(scope="module")
def fg():
    # demo parameters: sigma=4, security=128, 2^10 samples per vector
    # (reference tests/nfllib_demo_main_op.cpp:273)
    return FastGaussianNoise(4.0, 128, 1 << 10)


def test_table_shapes(fg):
    assert fg.lu_depth == 2
    assert fg.number_of_barriers == 1 + 2 * int(np.ceil(fg.tail_bound * 4.0))
    assert fg.bit_precision % 8 == 0
    assert fg.barriers == sorted(fg.barriers)
    assert fg.barriers[-1] < (1 << fg.bit_precision)
    # symmetric distribution: middle barrier ~ half of the mass
    mid = fg.barriers[len(fg.barriers) // 2]
    assert abs(mid - (1 << (fg.bit_precision - 1))) < (1 << (fg.bit_precision - 3))


def test_moments_and_tails(fg):
    s = Salsa20Stream(b"\x42" * 32)
    out = fg.get_noise(s, 50000)
    assert abs(float(out.mean())) < 0.1
    assert abs(float(out.std()) - 4.0) < 0.15
    # 6-sigma outliers ~ 1e-9 probability: none expected in 5e4 draws
    assert np.all(np.abs(out) <= 6 * 4.0 + 1)


def test_deterministic_given_stream(fg):
    a = fg.get_noise(Salsa20Stream(b"\x01" * 32), 4096)
    b = fg.get_noise(Salsa20Stream(b"\x01" * 32), 4096)
    np.testing.assert_array_equal(a, b)


def test_fixed_consumption_matches_distribution(fg):
    """The branchless sampler realizes the same CDF: for any randomness r the
    outputs of the LUT walk and searchsorted agree (spot-check by feeding the
    fixed sampler crafted randomness around barrier boundaries)."""
    rng = np.random.default_rng(7)
    wp = fg.word_precision
    # random draws
    r = rng.integers(0, 256, size=(2000, wp), dtype=np.uint16)
    # plus adversarial draws at exact barrier values and +-1
    adv = []
    for b in fg.barriers[:: max(1, len(fg.barriers) // 16)]:
        for delta in (-1, 0, 1):
            v = max(0, min((1 << fg.bit_precision) - 1, b + delta))
            adv.append([(v >> (fg.bit_precision - 8 * (j + 1))) & 0xFF
                        for j in range(wp)])
    r = np.concatenate([r, np.array(adv, dtype=np.uint16)], axis=0)
    out = fg.get_noise_fixed(r)
    # oracle: integer compare against barriers
    for i in range(r.shape[0]):
        x = 0
        for j in range(wp):
            x = (x << 8) | int(r[i, j])
        cnt = sum(1 for b in fg.barriers if b <= x)
        assert out[i] == fg.base_value + cnt


def test_gaussian_poly_encoding(fg):
    """Negative noise encodes as p + v per channel (core.hpp:306-316)."""
    ring = nfl.ring_from_modulus("u32", 64, 60)
    s = Salsa20Stream(b"\x05" * 32)
    p = nfl.Poly.sample(ring, nfl.gaussian(fg, 2), s)
    # re-derive from the same stream
    s2 = Salsa20Stream(b"\x05" * 32)
    noise = fg.get_noise(s2, 64) * 2
    arr = np.asarray(p.data)
    for cm in range(2):
        pm = int(ring.moduli[cm])
        want = np.where(noise < 0, pm + noise, noise)
        np.testing.assert_array_equal(arr[cm].astype(np.int64), want)


@pytest.mark.parametrize("security,samples", [
    (80, 1 << 10), (128, 1 << 10), (128, 1 << 14), (256, 1 << 16)])
@pytest.mark.parametrize("sigma", [2.0, 4.0, 8.0])
def test_decimal_barriers_match_libmpfr(sigma, security, samples):
    """The standard-library replay of the reference's MPFR op sequence gives
    the barriers libmpfr gives, bit for bit."""
    from nfllib_tpu.prng import mpfr_barriers

    if not mpfr_barriers.available():
        pytest.skip("libmpfr not loadable: nothing to compare against")
    g = FastGaussianNoise(sigma, security, samples)
    args = (g.sigma, g.center, g.rounded_center, g.number_of_barriers,
            g.bit_precision)
    assert mpfr_barriers.compute_barriers_decimal(*args) == \
        mpfr_barriers.compute_barriers(*args)


def test_sampler_without_libmpfr_matches(monkeypatch):
    """With libmpfr unavailable the sampler builds the same tables."""
    from nfllib_tpu.prng import mpfr_barriers

    want = FastGaussianNoise(4.0, 128, 1 << 10, center=0.3).barriers
    monkeypatch.setattr(mpfr_barriers, "available", lambda: False)
    got = FastGaussianNoise(4.0, 128, 1 << 10, center=0.3)
    assert got.barriers == want


def test_lwe_imports_without_mpmath(monkeypatch):
    """The LWE app (the main path) needs no mpmath: a fresh import of the
    package succeeds with mpmath made unimportable."""
    import importlib
    import sys

    for name in [m for m in sys.modules if m == "nfllib_tpu"
                 or m.startswith("nfllib_tpu.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "mpmath", None)
    with pytest.raises(ImportError):
        import mpmath  # noqa: F401
    lwe = importlib.import_module("nfllib_tpu.apps.lwe")
    g = lwe.make_gaussian_prng()
    assert g.barriers == FastGaussianNoise(4.0, 128, 1 << 10).barriers
