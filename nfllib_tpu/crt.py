"""CRT lifting between RNS residues and big integers.

Equivalent of the reference's GMP bridge (reference
include/nfl/gmp.hpp:113-219): device data stays in RNS; lifting happens on the
host in exact Python integers.  The reference's Shoup-style reduction modulo
the moduli product (gmp.hpp:198-204) is an exact algorithm, so plain
python-int reduction produces identical results.

poly2mpz:  x_i = (sum_cm lifting[cm] * residue[cm][i]) mod prod   (canonical)
mpz2poly:  residue[cm][i] = x_i mod p_cm  (floor division semantics, matching
           mpz_fdiv_ui for negative inputs, gmp.hpp:216)
"""
from __future__ import annotations

import numpy as np

from .poly import Poly
from .ring import Ring


def poly2mpz(p: Poly) -> list:
    """Lift an (unbatched) Poly to a list of `degree` python ints."""
    ctx = p.ring.context()
    arr = np.asarray(p.data)
    if arr.ndim != 2:
        raise ValueError("poly2mpz expects an unbatched [m, n] poly")
    from . import native
    if native.available():
        return native.poly2mpz_native(arr, ctx)
    prod = ctx.moduli_product
    lift = ctx.lifting_integers
    out = []
    for i in range(p.ring.degree):
        acc = 0
        for cm in range(p.ring.nmoduli):
            v = int(arr[cm, i])
            if v:
                acc += lift[cm] * v
        out.append(acc % prod)
    return out


def mpz2poly(ring: Ring, values) -> Poly:
    """Reduce `degree` python ints into RNS residues."""
    import jax.numpy as jnp
    n, m = ring.degree, ring.nmoduli
    vals = list(values)
    if len(vals) != n:
        raise ValueError(f"expected {n} coefficients, got {len(vals)}")
    from . import native
    if native.available() and all(v >= 0 for v in vals):
        return Poly(jnp.asarray(native.mpz2poly_native(vals, ring)), ring)
    data = np.zeros((m, n), dtype=ring.dtype)
    for cm in range(m):
        pm = int(ring.moduli[cm])
        data[cm] = [int(v) % pm for v in vals]
    return Poly(jnp.asarray(data), ring)


def set_mpz(ring: Ring, values) -> Poly:
    """set_mpz semantics (reference gmp.hpp:75-108): broadcast-or-full with
    per-channel reduction of arbitrarily large (possibly negative) ints."""
    import jax.numpy as jnp
    vals = [int(v) for v in values]
    n, m = ring.degree, ring.nmoduli
    if len(vals) > n and len(vals) != n * m:
        raise ValueError(
            "initializer of size above degree but not equal to nmoduli*degree")
    data = np.zeros((m, n), dtype=ring.dtype)
    if len(vals) == n * m:
        for cm in range(m):
            pm = int(ring.moduli[cm])
            data[cm] = [v % pm for v in vals[cm * n:(cm + 1) * n]]
    else:
        for cm in range(m):
            pm = int(ring.moduli[cm])
            data[cm][: len(vals)] = [v % pm for v in vals]
    return Poly(jnp.asarray(data), ring)
