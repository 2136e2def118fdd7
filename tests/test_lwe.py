"""End-to-end LWE symmetric encrypt/decrypt (the reference's acceptance
workload, tests/nfllib_demo_main_op.cpp:260-331): decryptions of encryptions
of zero must sum to exactly zero."""
import pytest

from nfllib_tpu.apps import lwe
from conftest import make_ring


@pytest.mark.parametrize("degree,agg,limb", [
    (128, 14, "u16"),
    (512, 60, "u32"),
])
def test_lwe_zero_sum(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    assert lwe.run_zero_sum_check(ring, repetitions=5, key=b"\x11" * 32)


@pytest.mark.slow
@pytest.mark.parametrize("degree,agg,limb", [
    (1024, 60, "u32"),
    (512, 124, "u64"),
])
def test_lwe_zero_sum_slow(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    assert lwe.run_zero_sum_check(ring, repetitions=3, key=b"\x22" * 32)


def test_encrypt_on_device_decrypts_to_zero():
    """Fully on-device pipeline (device Salsa20 + fixed-consumption Gaussian
    fused into the encrypt graph): decryptions must still be exact zeros."""
    import jax.numpy as jnp
    ring = make_ring(256, 60, "u32")
    stream = lwe.Salsa20Stream(b"\x31" * 32)
    g = lwe.make_gaussian_prng()
    keys = lwe.keygen(ring, stream, g)
    total = jnp.zeros(ring.shape, dtype=jnp.int64)
    for i in range(3):
        resa, resb = lwe.encrypt_on_device(keys, ring, b"\x32" * 32,
                                           100 + 3 * i, g)
        total = total + lwe.decrypt(keys, ring, resa, resb).astype(jnp.int64)
    assert bool(jnp.all(total == 0))


def test_encrypt_on_device_exact_matches_host():
    """exact=True on-device encryption is BIT-IDENTICAL to host encrypt()
    for a stream at the same (key, nonce): the stream-exact device Gaussian
    chains nonces in-graph exactly as the host walk's fill() calls do."""
    import numpy as np
    from nfllib_tpu.prng.salsa20 import Salsa20Stream

    ring = make_ring(256, 60, "u32")
    g = lwe.make_gaussian_prng(samples=256)
    key = b"\x31" * 32
    st = Salsa20Stream(key)
    keys = lwe.keygen(ring, st, g)
    enc_nonce = st.nonce
    ra_h, rb_h = lwe.encrypt(keys, ring, st, g)
    ra_d, rb_d = lwe.encrypt_on_device(keys, ring, key, enc_nonce, g,
                                       exact=True)
    np.testing.assert_array_equal(np.asarray(ra_h.data),
                                  np.asarray(ra_d.data))
    np.testing.assert_array_equal(np.asarray(rb_h.data),
                                  np.asarray(rb_d.data))


# Ring configurations of the LWE graphs, one or two per limb tier.
GRAPH_CONFIGS = [("u32", 512, 60), ("u32", 1024, 90), ("u16", 256, 14),
                 ("u64", 512, 124)]


def _graph_setup(limb, degree, agg, batch=3):
    import numpy as np

    from nfllib_tpu.prng.salsa20 import Salsa20Stream
    import nfllib_tpu as nfl

    ring = make_ring(degree, agg, limb)
    stream = Salsa20Stream(b"\x05" * 32)
    g = lwe.make_gaussian_prng()
    keys = lwe.keygen(ring, stream, g)

    def noise(mode):
        return np.stack([np.asarray(nfl.Poly.sample(ring, mode, stream).data)
                         for _ in range(batch)])

    u = noise(nfl.gaussian(g))
    e1, e2 = noise(nfl.gaussian(g, 2)), noise(nfl.gaussian(g, 2))
    return ring, keys, u, e1, e2


def _host_fwd(x, ring):
    """Batched forward transform by the python-int oracle."""
    import numpy as np
    from nfllib_tpu import oracle

    ctx = ring.context()
    return np.stack([oracle.ntt_pow_phi(v, ctx) for v in x]).astype(object)


def _col(ring):
    import numpy as np
    return np.array([int(p) for p in ring.moduli], dtype=object)[:, None]


@pytest.mark.parametrize("limb,degree,agg", GRAPH_CONFIGS)
def test_encrypt_graph_matches_reference(limb, degree, agg):
    """Batched encrypt graph == the demo's steps in python integers: each
    noise term transformed, then resa = e1 + u*pka, resb = e2 + u*pkb."""
    import numpy as np

    ring, keys, u, e1, e2 = _graph_setup(limb, degree, agg)
    ctx = ring.context()
    ra, rb = lwe._encrypt_graph(ctx, keys.pka.data, keys.pkb.data, u, e1, e2)
    p = _col(ring)
    un, e1n, e2n = (_host_fwd(v, ring) for v in (u, e1, e2))
    pka = np.asarray(keys.pka.data).astype(object)
    pkb = np.asarray(keys.pkb.data).astype(object)
    np.testing.assert_array_equal(np.asarray(ra).astype(object),
                                  (e1n + un * pka) % p)
    np.testing.assert_array_equal(np.asarray(rb).astype(object),
                                  (e2n + un * pkb) % p)


@pytest.mark.parametrize("limb,degree,agg", GRAPH_CONFIGS)
def test_decrypt_graph_matches_reference(limb, degree, agg):
    """Batched decrypt graph == the demo's steps in python integers:
    resb - resa*s, inverse transform, then the parity decode against p0/2
    — and every bit of an encryption of zero is 0."""
    import numpy as np
    from nfllib_tpu import oracle

    ring, keys, u, e1, e2 = _graph_setup(limb, degree, agg)
    ctx = ring.context()
    ra, rb = lwe._encrypt_graph(ctx, keys.pka.data, keys.pkb.data, u, e1, e2)
    got = np.asarray(lwe._decrypt_graph(ctx, ra, rb, keys.s.data,
                                        keys.sprime.data))
    p = _col(ring)
    s = np.asarray(keys.s.data).astype(object)
    tmp = (np.asarray(rb).astype(object)
           - np.asarray(ra).astype(object) * s) % p
    coeffs = np.stack([oracle.invntt_pow_invphi(t.astype(ring.dtype), ctx)
                       for t in tmp]).astype(object)
    half = int(ring.moduli[0]) // 2
    bit = coeffs % 2
    want = np.where(coeffs < half, bit, 1 - bit)
    np.testing.assert_array_equal(got.astype(object), want)
    assert not want.any()
