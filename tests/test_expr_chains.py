"""Lazy expression trees compile whole eager chains into ONE program.

The reference's expression templates evaluate arbitrary op chains in a single
pass over the coefficient array (reference include/nfl/ops.hpp:52-97,
core.hpp:25-37).  Here: `+ - *` build an Expr tree and evaluation
traces the whole tree into one jitted XLA program (poly._chain_program).
"""
import numpy as np
import pytest

import nfllib_tpu as nfl
from nfllib_tpu import poly as poly_mod

from conftest import rand_residues


@pytest.fixture
def ring():
    return nfl.ring_from_modulus("u32", 256, 60)


def _mk(ring, rng, k):
    return [nfl.Poly(rand_residues(ring, rng), ring) for _ in range(k)]


def test_chain_is_one_program(ring, rng):
    a, b, c, d = _mk(ring, rng, 4)
    poly_mod._chain_program_impl.cache_clear()
    e = a * b + c - d
    assert isinstance(e, poly_mod.Expr)
    assert poly_mod._chain_program_impl.cache_info().currsize == 0  # lazy
    r = e.poly()
    info = poly_mod._chain_program_impl.cache_info()
    assert info.currsize == 1           # the whole chain: one compiled program
    # re-evaluating an identically-shaped chain reuses it
    r2 = (b * a + d - c).poly()
    info = poly_mod._chain_program_impl.cache_info()
    assert info.currsize == 1 and info.hits >= 1
    assert r2.data.shape == r.data.shape


def test_chain_matches_eager_ops(ring, rng):
    a, b, c, d = _mk(ring, rng, 4)
    got = (a * b + c - d).poly()
    want = poly_mod._as_poly(poly_mod._as_poly(a.mulmod(b) + c) - d)
    np.testing.assert_array_equal(np.asarray(got.data),
                                  np.asarray(want.data))


def test_shoup_rewrite_inside_chain(ring, rng):
    """shoup(a*b, bprec) stays a single mulmod_shoup node inside a larger
    chain and equals the eager mulmod_shoup result."""
    a, b, c = _mk(ring, rng, 3)
    bprec = b.compute_shoup()
    lazy = (nfl.shoup(a * b, bprec) + c).poly()
    eager = a.mulmod_shoup(b, bprec) + c
    np.testing.assert_array_equal(np.asarray(lazy.data),
                                  np.asarray(poly_mod._as_poly(eager).data))


def test_shared_subtree_evaluates_once(ring, rng):
    a, b, c = _mk(ring, rng, 3)
    e = a * b
    r = (e + c) - e          # diamond: e appears twice
    want_e = a.mulmod(b)
    want = (want_e + c) - want_e
    np.testing.assert_array_equal(np.asarray(r.data),
                                  np.asarray(poly_mod._as_poly(want).data))


def test_expr_forwards_poly_surface(ring, rng):
    a, b = _mk(ring, rng, 2)
    e = a + b
    # NTT methods, serialization, accessors all force transparently
    assert e.serialize_manually() == poly_mod._as_poly(a + b).serialize_manually()
    f = e.ntt_pow_phi()
    back = f.invntt_pow_invphi()
    assert back == (a + b)
    assert e(0, 0) == int(poly_mod._as_poly(a + b).data[0, 0])


def test_forcing_inside_jit_does_not_leak_tracer(ring, rng):
    """An Expr built from concrete Polys but first forced INSIDE a jitted
    function must not memoize the traced value (regression: jax
    UnexpectedTracerError on the next outside-jit access)."""
    import jax

    a, b = _mk(ring, rng, 2)
    e = a + b                           # concrete leaves, unforced

    @jax.jit
    def f(x):
        return x + e.data               # forces e under the trace

    _ = np.asarray(f(a.data))
    # second access outside the trace: must re-evaluate, not return a tracer
    outside = np.asarray(e.data)
    want = np.asarray(poly_mod._as_poly(a + b).data)
    np.testing.assert_array_equal(outside, want)


def test_program_first_built_inside_jit_is_reusable(rng):
    """The lru-cached op/chain builders must not materialize their constants
    under an outer jit trace (they would cache tracers; same bug class as
    the u64 chain builder leak).  Build every cached program inside a jit
    first, then reuse it eagerly."""
    import jax

    fresh = nfl.ring_from_modulus("u32", 128, 60)   # un-cached ring
    a = nfl.Poly(rand_residues(fresh, rng), fresh)
    b = nfl.Poly(rand_residues(fresh, rng), fresh)

    @jax.jit
    def f(x, y):
        tmp = nfl.Poly(x, fresh)
        other = nfl.Poly(y, fresh)
        return (tmp * other + tmp).poly().ntt_pow_phi().data

    inside = np.asarray(f(a.data, b.data))
    outside = np.asarray((a * b + a).poly().ntt_pow_phi().data)
    np.testing.assert_array_equal(inside, outside)


def test_ring_mismatch_raises(ring, rng):
    other = nfl.ring_from_modulus("u32", 512, 60)
    a = nfl.Poly(rand_residues(ring, rng), ring)
    b = nfl.Poly(rand_residues(other, rng), other)
    with pytest.raises(ValueError):
        a + b


def test_ring_mismatch_raises_fused_ops(ring, rng):
    """The fused operators must guard like the expression operators do —
    before the guard, mismatched operands silently broadcast and produced
    wrong residues (round-5 library review)."""
    other = nfl.ring_from_modulus("u32", 512, 60)
    a = nfl.Poly(rand_residues(ring, rng), ring)
    b = nfl.Poly(rand_residues(other, rng), other)
    bp = b.compute_shoup()
    sameb = nfl.Poly(rand_residues(ring, rng), ring)
    samebp = sameb.compute_shoup()
    with pytest.raises(ValueError):
        a.mulmod_shoup(b, bp)
    with pytest.raises(ValueError):
        a.mulmod_shoup(sameb, bp)       # prec from the wrong ring alone
    with pytest.raises(ValueError):
        a.muladd(b, b)
    with pytest.raises(ValueError):
        a.muladd_shoup(sameb, b, bp)


@pytest.mark.parametrize("limb,degree,agg", [
    ("u16", 128, 14),
    ("u32", 256, 60),
    ("u64", 64, 124),
])
def test_random_tree_differential_fuzz(limb, degree, agg, rng):
    """Random expression trees (the reference evaluates arbitrary op chains,
    ops.hpp:52-97) must match an exact big-int oracle at every tier —
    including shared subtrees (CSE) and embedded shoup() rewrites."""
    ring = nfl.ring_from_modulus(limb, degree, agg)
    moduli = [int(p) for p in ring.moduli]

    def leaf_pool(k):
        polys = _mk(ring, rng, k)
        vals = [np.asarray(p.data).astype(object) for p in polys]
        return polys, vals

    def oracle_op(op, a, b):
        out = np.empty_like(a)
        for cm, p in enumerate(moduli):
            if op == "add":
                out[cm] = (a[cm] + b[cm]) % p
            elif op == "sub":
                out[cm] = (a[cm] - b[cm]) % p
            else:
                out[cm] = (a[cm] * b[cm]) % p
        return out

    pyrng = np.random.default_rng(1234 + degree)
    for trial in range(6):
        polys, vals = leaf_pool(4)

        def build(depth):
            if depth == 0 or pyrng.random() < 0.3:
                i = int(pyrng.integers(len(polys)))
                return polys[i], vals[i]
            op = ("add", "sub", "mul")[int(pyrng.integers(3))]
            le, lv = build(depth - 1)
            re_, rv = build(depth - 1)
            expr = {"add": lambda x, y: x + y,
                    "sub": lambda x, y: x - y,
                    "mul": lambda x, y: x * y}[op](le, re_)
            return expr, oracle_op(op, lv, rv)

        expr, want = build(int(pyrng.integers(2, 5)))
        if not isinstance(expr, poly_mod.Expr):
            continue
        # sometimes wrap a product leaf pair in the shoup rewrite and add it
        if trial % 2 == 0:
            b = polys[1]
            sh = nfl.shoup(polys[0] * b, b.compute_shoup())
            expr = expr + sh
            want = oracle_op("add", want,
                             oracle_op("mul", vals[0], vals[1]))
        got = np.asarray(expr.poly().data).astype(object)
        np.testing.assert_array_equal(got, want)
