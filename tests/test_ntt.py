"""NTT correctness: oracle differential, DFT ordering, round-trips, products
(mirrors the reference's transitive NTT coverage via ntt_perfs.cpp and the
LWE demo round-trip, plus an independent evaluation-map ordering check)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nfllib_tpu as nfl
from nfllib_tpu import oracle
from nfllib_tpu.ops import ntt as ntt_mod
from nfllib_tpu.utils import bitrev_indices

from conftest import (CONFIG_MATRIX, CONFIG_MATRIX_FULL, SMALL_MATRIX,
                      make_ring, rand_residues)


@pytest.mark.parametrize("degree,agg,limb", SMALL_MATRIX)
def test_ntt_matches_scalar_oracle(degree, agg, limb, rng):
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng)
    got = np.asarray(ntt_mod.ntt_pow_phi(jnp.asarray(x), ctx))
    want = oracle.ntt_pow_phi(x, ctx)
    np.testing.assert_array_equal(got, want)
    # inverse path
    gi = np.asarray(ntt_mod.invntt_pow_invphi(jnp.asarray(got), ctx))
    wi = oracle.invntt_pow_invphi(want, ctx)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gi, x)


@pytest.mark.parametrize("degree,agg,limb", [(16, 60, "u32"), (8, 14, "u16"),
                                             (8, 124, "u64")])
def test_forward_ordering_is_bitrev_of_evaluation(degree, agg, limb, rng):
    """out[j] = A(phi^(2*bitrev(j)+1)) — pins the Harvey output convention."""
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng)
    got = np.asarray(ntt_mod.ntt_pow_phi(jnp.asarray(x), ctx))
    ev = oracle.dft_eval(x, ctx)
    rev = bitrev_indices(degree)
    np.testing.assert_array_equal(got, ev[:, rev])


@pytest.mark.parametrize("degree,agg,limb", CONFIG_MATRIX)
def test_roundtrip_full_matrix(degree, agg, limb, rng):
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng)
    fwd = ntt_mod.ntt_pow_phi(jnp.asarray(x), ctx)
    back = np.asarray(ntt_mod.invntt_pow_invphi(fwd, ctx))
    np.testing.assert_array_equal(back, x)


@pytest.mark.slow
@pytest.mark.parametrize("degree,agg,limb", CONFIG_MATRIX_FULL)
def test_roundtrip_reference_matrix(degree, agg, limb, rng):
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng)
    fwd = ntt_mod.ntt_pow_phi(jnp.asarray(x), ctx)
    back = np.asarray(ntt_mod.invntt_pow_invphi(fwd, ctx))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("degree,agg,limb", SMALL_MATRIX)
def test_pointwise_mul_is_negacyclic_product(degree, agg, limb, rng):
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    a = rand_residues(ring, rng)
    b = rand_residues(ring, rng)
    pa = nfl.Poly(jnp.asarray(a), ring).ntt_pow_phi()
    pb = nfl.Poly(jnp.asarray(b), ring).ntt_pow_phi()
    prod = pa.mulmod(pb).invntt_pow_invphi()
    want = oracle.negacyclic_mul_schoolbook(a, b, ring)
    np.testing.assert_array_equal(np.asarray(prod.data), want)


def test_batched_and_jitted(rng):
    ring = make_ring(64, 60, "u32")
    ctx = ring.context()
    x = rand_residues(ring, rng, batch=(4,))
    f = jax.jit(lambda v: ntt_mod.invntt_pow_invphi(
        ntt_mod.ntt_pow_phi(v, ctx), ctx))
    got = np.asarray(f(jnp.asarray(x)))
    np.testing.assert_array_equal(got, x)
    # batch consistency with unbatched path
    one = np.asarray(ntt_mod.ntt_pow_phi(jnp.asarray(x[2]), ctx))
    batched = np.asarray(ntt_mod.ntt_pow_phi(jnp.asarray(x), ctx))[2]
    np.testing.assert_array_equal(one, batched)


def test_degree_2_special_case(rng):
    ring = make_ring(2, 60, "u32")
    ctx = ring.context()
    x = rand_residues(ring, rng)
    fwd = ntt_mod.ntt_pow_phi(jnp.asarray(x), ctx)
    back = np.asarray(ntt_mod.invntt_pow_invphi(fwd, ctx))
    np.testing.assert_array_equal(back, x)


def test_random_config_property_fuzz(rng):
    """Randomized ring configs beyond the fixed reference matrix: roundtrip,
    NTT linearity, and the convolution theorem vs the schoolbook oracle at
    random (limb, degree, channel-count) draws."""
    pyrng = np.random.default_rng(99)
    for trial in range(6):
        limb = ("u16", "u32", "u64")[trial % 3]
        degree = int(pyrng.choice([8, 16, 32, 64, 128, 256]))
        per = {"u16": 14, "u32": 30, "u64": 62}[limb]
        m = int(pyrng.integers(1, {"u16": 2, "u32": 4, "u64": 3}[limb] + 1))
        ring = nfl.ring_from_modulus(limb, degree, per * m)
        a = nfl.Poly(jnp.asarray(rand_residues(ring, rng)), ring)
        b = nfl.Poly(jnp.asarray(rand_residues(ring, rng)), ring)
        an, bn = a.ntt_pow_phi(), b.ntt_pow_phi()
        assert an.invntt_pow_invphi() == a          # roundtrip
        lhs = (a + b).poly().ntt_pow_phi()          # linearity
        assert lhs == (an + bn).poly()
        prod = an.mulmod(bn).invntt_pow_invphi()    # convolution theorem
        want = oracle.negacyclic_mul_schoolbook(
            np.asarray(a.data), np.asarray(b.data), ring)
        np.testing.assert_array_equal(
            np.asarray(prod.data).astype(object), want)


# Ring configurations across the three limb tiers: the reference matrix's
# points, each tier's largest degree the tables allow in test time, odd
# channel counts, and 2-channel u16.
TRANSFORM_CONFIGS = [
    (8, 60, "u32"), (64, 60, "u32"), (256, 60, "u32"), (512, 90, "u32"),
    (1024, 60, "u32"), (4096, 60, "u32"), (8192, 60, "u32"),
    (128, 14, "u16"), (256, 28, "u16"), (512, 14, "u16"),
    (64, 124, "u64"), (256, 62, "u64"), (256, 124, "u64"),
    (512, 124, "u64"), (1024, 124, "u64"), (8192, 124, "u64"),
]


def _oracle_batched(fn, x, ctx):
    flat = x.reshape((-1,) + x.shape[-2:])
    return np.stack([fn(v, ctx) for v in flat]).reshape(x.shape)


@pytest.mark.parametrize("degree,agg,limb", TRANSFORM_CONFIGS)
def test_forward_matches_oracle(degree, agg, limb, rng):
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng, batch=(2,))
    got = np.asarray(jax.jit(lambda v: ntt_mod.ntt_pow_phi(v, ctx))(x))
    np.testing.assert_array_equal(
        got, _oracle_batched(oracle.ntt_pow_phi, x, ctx))


@pytest.mark.parametrize("degree,agg,limb", TRANSFORM_CONFIGS)
def test_inverse_matches_oracle(degree, agg, limb, rng):
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng, batch=(2,))
    f = _oracle_batched(oracle.ntt_pow_phi, x, ctx)
    got = np.asarray(jax.jit(lambda v: ntt_mod.invntt_pow_invphi(v, ctx))(f))
    np.testing.assert_array_equal(
        got, _oracle_batched(oracle.invntt_pow_invphi, f, ctx))
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("inverse_tables", [False, True])
@pytest.mark.parametrize("degree,agg,limb", [
    (256, 60, "u32"), (512, 14, "u16"), (256, 124, "u64"),
    (1024, 124, "u64")])
def test_plain_pass_matches_oracle(degree, agg, limb, inverse_tables, rng):
    """ntt() alone (no twist, no permutation) with the forward or the
    inverse twiddle tables."""
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng)
    got = np.asarray(ntt_mod.ntt(x, ctx, inverse_tables=inverse_tables))
    w, ws = ((ctx.invomegas, ctx.shoupinvomegas) if inverse_tables
             else (ctx.omegas, ctx.shoupomegas))
    for cm in range(ring.nmoduli):
        want = oracle.ntt(x[cm], w[cm], ws[cm], int(ring.moduli[cm]),
                          ring.repr_bits)
        np.testing.assert_array_equal(got[cm].astype(object), want)


@pytest.mark.parametrize("degree,agg,limb", [
    (256, 60, "u32"), (512, 14, "u16"), (256, 124, "u64")])
def test_raw_inverse_matches_oracle(degree, agg, limb, rng):
    """inv_ntt (bit-reverse, inverse-table pass, bit-reverse; no n^-1)."""
    ring = make_ring(degree, agg, limb)
    ctx = ring.context()
    x = rand_residues(ring, rng)
    got = np.asarray(ntt_mod.inv_ntt(x, ctx))
    for cm in range(ring.nmoduli):
        want = oracle.inv_ntt(x[cm], ctx.invomegas[cm],
                              ctx.shoupinvomegas[cm],
                              int(ring.moduli[cm]), ring.repr_bits)
        np.testing.assert_array_equal(got[cm].astype(object), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch", [(), (3,), (2, 5)])
def test_odd_batch_shapes(batch, inverse, rng):
    """Leading batch axes of any shape transform element by element."""
    ring = make_ring(256, 60, "u32")
    ctx = ring.context()
    x = rand_residues(ring, rng, batch=batch)
    fn = ntt_mod.invntt_pow_invphi if inverse else ntt_mod.ntt_pow_phi
    ref = oracle.invntt_pow_invphi if inverse else oracle.ntt_pow_phi
    got = np.asarray(fn(jnp.asarray(x), ctx))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, _oracle_batched(ref, x, ctx))
