"""Strict-mod assertion mode (reference CHECK_STRICTMOD, debug.hpp:33-37)."""
import numpy as np
import pytest

import jax.numpy as jnp

import nfllib_tpu as nfl
from nfllib_tpu import debug


@pytest.fixture(autouse=True)
def _strict():
    debug.set_strictmod(True)
    yield
    debug.set_strictmod(False)


def test_out_of_range_operand_raises():
    ring = nfl.ring_from_modulus("u32", 64, 60)
    good = nfl.Poly.zeros(ring)
    bad = nfl.Poly(jnp.full(ring.shape, jnp.uint32(0xFFFFFFFF)), ring)
    with pytest.raises(AssertionError, match="STRICTMOD"):
        _ = bad + good


def test_in_range_passes():
    ring = nfl.ring_from_modulus("u32", 64, 60)
    s = None
    from nfllib_tpu.prng.salsa20 import Salsa20Stream
    s = Salsa20Stream(b"\x01" * 32)
    a = nfl.Poly.sample(ring, nfl.uniform(), s)
    b = nfl.Poly.sample(ring, nfl.uniform(), s)
    _ = (a + b).ntt_pow_phi()   # must not raise


def test_lazy_intermediate_trips_inside_jit():
    """Per-op bracket (reference debug.hpp:33-37 asserts inside every modular
    functor): an out-of-range intermediate inside a jitted program trips the
    modops-level check, not just the Poly operator boundary."""
    import jax
    from nfllib_tpu.ops import modops

    ring = nfl.ring_from_modulus("u32", 64, 60)
    ctx = ring.context()
    p = jnp.asarray(ctx.p_col)

    @jax.jit
    def f(x):
        lazy = x + x                  # raw sum, lands in [0, 2p): not strict
        return modops.addmod(lazy, x, p)

    x = jnp.full(ring.shape, jnp.uint32(int(ring.moduli[0]) - 1))
    with pytest.raises(Exception, match="STRICTMOD"):
        np.asarray(f(x))


def test_eager_modops_check():
    from nfllib_tpu.ops import modops
    ring = nfl.ring_from_modulus("u32", 64, 60)
    p = jnp.asarray(ring.context().p_col)
    bad = jnp.full(ring.shape, jnp.uint32(0xFFFFFFFF))
    good = jnp.zeros(ring.shape, jnp.uint32)
    with pytest.raises(AssertionError, match="STRICTMOD"):
        modops.submod(good, bad, p)
    with pytest.raises(AssertionError, match="STRICTMOD"):
        modops.mulmod(bad, good, p, jnp.asarray(ring.context().pn_col))


def test_strict_toggle_retraces_cached_programs():
    """Flipping strictmod must not reuse programs traced under the other
    setting (the jit caches are keyed on the flag)."""
    ring = nfl.ring_from_modulus("u32", 64, 60)
    bad = nfl.Poly(jnp.full(ring.shape, jnp.uint32(0xFFFFFFFF)), ring)
    debug.set_strictmod(False)
    _ = (bad + bad).poly()            # traces the non-strict chain program
    debug.set_strictmod(True)
    with pytest.raises(Exception, match="STRICTMOD"):
        _ = (bad + bad).poly()


def test_flag_toggles():
    assert debug.strictmod_enabled()
    debug.set_strictmod(False)
    assert not debug.strictmod_enabled()
    ring = nfl.ring_from_modulus("u32", 64, 60)
    bad = nfl.Poly(jnp.full(ring.shape, jnp.uint32(0xFFFFFFFF)), ring)
    _ = bad + bad               # no check when disabled


@pytest.mark.parametrize("limb,agg", [("u16", 14), ("u32", 60), ("u64", 124)])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_transform_boundary_rejects_out_of_range(limb, agg, direction):
    """Strict mode asserts the [0, p) contract on a transform's input
    (reference sse.hpp:57-67 asserts in its NTT paths), eagerly and inside
    jit."""
    import jax
    from nfllib_tpu.ops import ntt as ntt_mod

    ring = nfl.ring_from_modulus(limb, 64, agg)
    ctx = ring.context()
    fn = (ntt_mod.ntt_pow_phi if direction == "forward"
          else ntt_mod.invntt_pow_invphi)
    bad = jnp.full(ring.shape, int(ring.moduli[0]), dtype=ring.dtype)
    with pytest.raises(AssertionError, match="STRICTMOD"):
        fn(bad, ctx)
    with pytest.raises(Exception, match="STRICTMOD"):
        np.asarray(jax.jit(lambda v: fn(v, ctx))(bad))


@pytest.mark.parametrize("limb,agg", [("u16", 14), ("u32", 60), ("u64", 124)])
def test_strict_transforms_bit_identical(limb, agg):
    """On valid data the strict build gives the same outputs as the normal
    one, forward and inverse."""
    from nfllib_tpu.ops import ntt as ntt_mod
    from nfllib_tpu.prng.salsa20 import Salsa20Stream

    ring = nfl.ring_from_modulus(limb, 128, agg)
    ctx = ring.context()
    x = nfl.Poly.sample(ring, nfl.uniform(), Salsa20Stream(b"\x02" * 32)).data
    strict_f = np.asarray(ntt_mod.ntt_pow_phi(x, ctx))
    strict_i = np.asarray(ntt_mod.invntt_pow_invphi(strict_f, ctx))
    debug.set_strictmod(False)
    np.testing.assert_array_equal(np.asarray(ntt_mod.ntt_pow_phi(x, ctx)),
                                  strict_f)
    np.testing.assert_array_equal(strict_i, np.asarray(x))
