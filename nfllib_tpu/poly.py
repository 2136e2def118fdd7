"""Poly — the polynomial value type (reference include/nfl/poly.hpp).

A Poly is an immutable pytree holding a residue tensor of shape
[..., nmoduli, degree] in the ring's limb dtype plus a static `Ring`.  Leading
axes are free batch dimensions (the replacement for the reference's
arrays-of-poly).  JAX's immutable arrays give the value semantics that the
reference's poly_p copy-on-write wrapper (poly_p.hpp:10-204) exists to
approximate — poly and poly_p collapse into this one type (PolyP is an alias).

Operator sugar mirrors the reference's expression-template surface
(poly.hpp:346-352): `+ - *` build a lazy `Expr` op tree, and the whole tree
traces into ONE jitted XLA program when a value is demanded — the analog
of the reference's single-pass assignment loop (core.hpp:25-37): an eager
chain like `a*b + c - d` makes one HBM round trip, not one per op.  The
`shoup(a * b, bprec)` pattern rewrite to a fused mulmod_shoup (the one
rewrite the reference implements, ops.hpp:267-277) is preserved as an Expr
node kind, because Shoup multiplication is a different (division-free)
algorithm, not just a fusion.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .ops import modops
from .ops import ntt as ntt_mod
from .ring import Ring
from . import debug
from .prng.sampling import (  # re-exported mode tags
    ZO_dist,
    gaussian,
    hwt_dist,
    non_uniform,
    sample,
    uniform,
)

__all__ = [
    "Poly",
    "PolyP",
    "Expr",
    "MulExpr",
    "shoup",
    "compute_shoup",
    "uniform",
    "non_uniform",
    "ZO_dist",
    "hwt_dist",
    "gaussian",
]

import functools


@functools.lru_cache(maxsize=None)
def _jitted_impl(ring: Ring, name: str, strict: bool):
    """One compiled graph per (ring, op): whole op chains (e.g. the full
    log2(n)-stage NTT) compile as a single XLA program instead of per-stage
    eager dispatch.  jit re-specializes per batch shape automatically.
    `strict` keys the cache on strictmod so the in-op asserts that modops
    traces under the flag (debug.op_check) appear/disappear on toggle.

    Constants come from numpy inside the jitted functions: this builder is
    lru-cached, and materializing jnp arrays at build time under an outer
    jit trace would cache tracers (UnexpectedTracerError later)."""
    ctx = ring.context()
    p = ctx.p_col
    pn = ctx.pn_col
    fns = {
        "add": lambda x, y: modops.addmod(x, y, p),
        "sub": lambda x, y: modops.submod(x, y, p),
        "mul": lambda x, y: modops.mulmod(x, y, p, pn),
        "mul_shoup": lambda x, y, yp: modops.mulmod_shoup(x, y, yp, p),
        "muladd": lambda r, x, y: modops.muladd(r, x, y, p, pn),
        "muladd_shoup": lambda r, x, y, yp: modops.muladd_shoup(
            r, x, y, yp, p),
        "compute_shoup": lambda x: modops.compute_shoup(x, p),
        "ntt_pow_phi": lambda x: ntt_mod.ntt_pow_phi(x, ctx),
        "invntt_pow_invphi": lambda x: ntt_mod.invntt_pow_invphi(x, ctx),
    }
    return jax.jit(fns[name])


def _jitted(ring: Ring, name: str):
    return _jitted_impl(ring, name, debug.strictmod_enabled())


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Poly:
    data: Any              # [..., nmoduli, degree] array, limb dtype
    ring: Ring             # static

    # --- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.data,), self.ring

    @classmethod
    def tree_unflatten(cls, ring, children):
        return cls(children[0], ring)

    # --- constructors -------------------------------------------------------
    @classmethod
    def zeros(cls, ring: Ring, batch=()):
        return cls(jnp.zeros(tuple(batch) + ring.shape, dtype=ring.dtype), ring)

    @classmethod
    def from_coeffs(cls, ring: Ring, values, reduce_coeffs: bool = True):
        """set(It, It) semantics (reference core.hpp:103-136): either up to
        `degree` coefficients broadcast to every channel (zero padded), or the
        full nmoduli*degree array."""
        vals = [int(v) for v in np.asarray(values).reshape(-1)]
        n, m = ring.degree, ring.nmoduli
        if len(vals) > n and len(vals) != n * m:
            raise ValueError(
                "initializer of size above degree but not equal to "
                "nmoduli*degree")
        data = np.zeros((m, n), dtype=ring.dtype)
        mask = (1 << ring.repr_bits) - 1
        if len(vals) == n * m:
            for cm in range(m):
                p = int(ring.moduli[cm])
                row = vals[cm * n:(cm + 1) * n]
                data[cm] = [(v % p if reduce_coeffs else v) & mask for v in row]
        else:
            for cm in range(m):
                p = int(ring.moduli[cm])
                data[cm][: len(vals)] = [
                    (v % p if reduce_coeffs else v) & mask for v in vals]
        return cls(jnp.asarray(data), ring)

    @classmethod
    def constant(cls, ring: Ring, v: int, reduce_coeffs: bool = True):
        if v == 0:
            return cls.zeros(ring)
        return cls.from_coeffs(ring, [v], reduce_coeffs)

    @classmethod
    def sample(cls, ring: Ring, mode, stream):
        """Draw a random polynomial (reference poly(mode) constructors)."""
        return cls(jnp.asarray(sample(ring, mode, stream)), ring)

    @classmethod
    def sample_on_device(cls, ring: Ring, mode, key: bytes, nonce: int = 0):
        """Draw a random polynomial with the keystream generated and consumed
        on the accelerator (prng/device_sampling.py); jit/fusion friendly."""
        from .prng.device_sampling import device_sample
        return cls(device_sample(ring, mode, key, nonce), ring)

    # --- basic introspection -------------------------------------------------
    @property
    def batch_shape(self):
        return tuple(self.data.shape[:-2])

    @property
    def nmoduli(self):
        return self.ring.nmoduli

    @property
    def degree(self):
        return self.ring.degree

    def get_modulus(self, cm: int) -> int:
        return int(self.ring.moduli[cm])

    def __call__(self, cm: int, i: int) -> int:
        """Residue accessor `p(cm, i)` (reference poly.hpp:156-158)."""
        return int(self.data[..., cm, i])

    def __iter__(self):
        """Iterate residues in storage order (reference begin()/end():
        moduli-major over the flat array)."""
        return iter(np.asarray(self.data).reshape(-1).tolist())

    def __bool__(self):
        # reference operator bool: any nonzero coefficient (core.hpp:39-43)
        return bool(jnp.any(self.data != 0))

    def __repr__(self):
        return (f"Poly(ring={self.ring.limb}/n={self.ring.degree}"
                f"/m={self.ring.nmoduli}, batch={self.batch_shape})")

    def __str__(self):
        """Reference operator<< format (core.hpp:398-421): residues in
        storage order as a C initializer list with the limb suffix printed
        AFTER each value-but-the-first's predecessor — i.e.
        '{ 1UL, 2UL, 3UL }' for u32 (suffixes ULL/UL/U per limb)."""
        term = {"u64": "ULL", "u32": "UL", "u16": "U"}[self.ring.limb]
        out = ["{ "]
        first = True
        for v in self:
            if first:
                first = False
                out.append(str(v))
            else:
                out.append(f"{term}, {v}")
        out.append(f"{term} }}")
        return "".join(out)

    # --- helpers -------------------------------------------------------------
    def _ctx(self):
        return self.ring.context()

    def _consts(self):
        ctx = self._ctx()
        return jnp.asarray(ctx.p_col), jnp.asarray(ctx.pn_col)

    def _strict_check(self, *polys):
        if debug.strictmod_enabled():
            p = jnp.asarray(self._ctx().p_col)
            for q in polys:
                debug.check_residues(q.data, p)

    def _check_same_ring(self, other: "Poly"):
        if self.ring != other.ring:
            raise ValueError(f"ring mismatch: {self.ring} vs {other.ring}")

    def _wrap(self, data):
        return Poly(data, self.ring)

    # --- arithmetic (reference poly.hpp:346-352 operator set) ----------------
    # `+ - *` are lazy: they build an Expr op tree that compiles into one XLA
    # program on demand (reference expression templates, ops.hpp:52-97).
    def __add__(self, other):
        return Expr("add", (self, _as_operand(other)))

    def __sub__(self, other):
        return Expr("sub", (self, _as_operand(other)))

    def __mul__(self, other):
        return Expr("mul", (self, _as_operand(other)))

    def __radd__(self, other):
        return Expr("add", (_as_operand(other), self))

    def __rsub__(self, other):
        return Expr("sub", (_as_operand(other), self))

    def __rmul__(self, other):
        return Expr("mul", (_as_operand(other), self))

    def __eq__(self, other):
        if isinstance(other, Expr):
            other = other.poly()
        if not isinstance(other, Poly) or other.ring != self.ring:
            return NotImplemented
        return bool(jnp.all(self.data == other.data))

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None

    def eqmod(self, other):
        """Elementwise equality mask (reference ops eqmod)."""
        return self.data == _as_poly(other).data

    def mulmod(self, other):
        """Pointwise modular multiplication (single compiled pass)."""
        other = _as_poly(other)
        self._check_same_ring(other)
        self._strict_check(self, other)
        return self._wrap(_jitted(self.ring, "mul")(self.data, other.data))

    def mulmod_shoup(self, other, other_prec):
        other = _as_poly(other)
        self._check_same_ring(other)
        self._check_same_ring(other_prec)
        self._strict_check(self, other)
        return self._wrap(_jitted(self.ring, "mul_shoup")(
            self.data, other.data, other_prec.data))

    def muladd(self, x, y):
        """self + x*y mod p, fused (reference opt/ops.hpp muladd)."""
        self._check_same_ring(x)
        self._check_same_ring(y)
        return self._wrap(_jitted(self.ring, "muladd")(
            self.data, x.data, y.data))

    def muladd_shoup(self, x, y, yprec):
        self._check_same_ring(x)
        self._check_same_ring(y)
        self._check_same_ring(yprec)
        return self._wrap(_jitted(self.ring, "muladd_shoup")(
            self.data, x.data, y.data, yprec.data))

    def compute_shoup(self):
        """Precompute Shoup companions (reference ops.hpp:165-177)."""
        return self._wrap(_jitted(self.ring, "compute_shoup")(self.data))

    # --- NTT (reference poly.hpp:167-168) -------------------------------------
    def ntt_pow_phi(self):
        self._strict_check(self)
        return self._wrap(_jitted(self.ring, "ntt_pow_phi")(self.data))

    def invntt_pow_invphi(self):
        return self._wrap(_jitted(self.ring, "invntt_pow_invphi")(self.data))

    # --- serialization / CRT bridges ------------------------------------------
    def serialize_manually(self) -> bytes:
        from .serialize import serialize_poly
        return serialize_poly(self)

    def poly2mpz(self):
        from .crt import poly2mpz
        return poly2mpz(self)


# poly_p parity alias: JAX immutability already provides cheap value semantics
# (the COW wrapper of reference poly_p.hpp:10-204 has nothing left to do).
PolyP = Poly


@functools.lru_cache(maxsize=None)
def _chain_program_impl(ring: Ring, key, strict: bool):
    """One compiled XLA program per (ring, op-tree shape).  `key` is a nested
    tuple of op names with leaf indices at the leaves; the program takes the
    leaf residue tensors positionally.  This is the single-pass-per-chain
    contract of the reference's expression templates (core.hpp:25-37): XLA
    fuses the whole elementwise tree into one kernel.  `strict` keys the
    cache on strictmod (modops traces per-op asserts under the flag).
    Constants stay numpy outside the jitted fn (see _jitted_impl)."""
    ctx = ring.context()
    p = ctx.p_col
    pn = ctx.pn_col

    def run(*leaves):
        memo = {}

        def ev(k):
            if isinstance(k, int):
                return leaves[k]
            if k in memo:          # trace-time CSE for shared subtrees
                return memo[k]
            op = k[0]
            if op == "add":
                # fused-FMA rewrite: add(mul(a,b), c) / add(c, mul(a,b))
                # lowers to ONE muladd (reference opt/ops.hpp:7-48).  Both
                # paths canonicalize the product before the add, so the
                # rewrite is bit-identical to addmod(mulmod(a,b), c).
                lhs, rhs = k[1], k[2]
                if isinstance(lhs, tuple) and lhs[0] == "mul":
                    r = modops.muladd(ev(rhs), ev(lhs[1]), ev(lhs[2]), p, pn)
                elif isinstance(rhs, tuple) and rhs[0] == "mul":
                    r = modops.muladd(ev(lhs), ev(rhs[1]), ev(rhs[2]), p, pn)
                else:
                    r = modops.addmod(ev(lhs), ev(rhs), p)
            elif op == "sub":
                r = modops.submod(ev(k[1]), ev(k[2]), p)
            elif op == "mul":
                r = modops.mulmod(ev(k[1]), ev(k[2]), p, pn)
            else:                  # "shoup"
                r = modops.mulmod_shoup(ev(k[1]), ev(k[2]), ev(k[3]), p)
            memo[k] = r
            return r

        return ev(key)

    return jax.jit(run)


def _chain_program(ring: Ring, key):
    return _chain_program_impl(ring, key, debug.strictmod_enabled())


class Expr:
    """Lazy elementwise op tree (reference ops::expr, ops.hpp:52-97).

    Nodes: add / sub / mul / shoup(a, b, bprec); operands are Polys or nested
    Exprs.  Demanding a value (``.poly()``, ``.data``, comparison, NTT, any
    Poly method) flattens the tree to a shape key, compiles ONE jitted program
    for that shape (cached per ring), and runs it over the leaf tensors — so
    an eager chain is a single pass over memory regardless of length, like
    the reference's assignment loop (core.hpp:25-37).
    """

    __slots__ = ("op", "args", "ring", "_val", "depth")

    # Trees deeper than this force their deep operands eagerly: accumulation
    # loops (`acc = acc + x` repeated) would otherwise mint a distinct,
    # ever-deeper tree shape per iteration — a fresh XLA compile each force,
    # a permanently cached program each shape, and eventually a Python
    # recursion-limit blowout in _flatten.
    _MAX_DEPTH = 32

    def __init__(self, op: str, args):
        args = tuple(
            a.poly() if isinstance(a, Expr) and a.depth >= self._MAX_DEPTH
            else a
            for a in args)
        ring = args[0].ring
        for a in args[1:]:
            if a.ring != ring:
                raise ValueError(f"ring mismatch: {ring} vs {a.ring}")
        if debug.strictmod_enabled():
            # reference CHECK_STRICTMOD asserts at every op boundary
            # (debug.hpp:33-37) — check Poly operands when the node is built,
            # not only when the tree is forced.
            p = jnp.asarray(ring.context().p_col)
            for a in args:
                if isinstance(a, Poly):
                    debug.check_residues(a.data, p)
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "args", tuple(args))
        object.__setattr__(self, "ring", ring)
        object.__setattr__(self, "_val", None)
        object.__setattr__(self, "depth", 1 + max(
            (a.depth for a in args if isinstance(a, Expr)), default=0))

    # --- evaluation ---------------------------------------------------------
    def _flatten(self, leaves, index_by_id):
        parts = [self.op]
        for a in self.args:
            if isinstance(a, Expr):
                parts.append(a._flatten(leaves, index_by_id))
            else:
                k = id(a)
                if k not in index_by_id:
                    index_by_id[k] = len(leaves)
                    leaves.append(a)
                parts.append(index_by_id[k])
        return tuple(parts)

    def poly(self) -> Poly:
        if self._val is not None:
            return self._val
        leaves: list = []
        key = self._flatten(leaves, {})
        if debug.strictmod_enabled():
            p = jnp.asarray(self.ring.context().p_col)
            for leaf in leaves:
                debug.check_residues(leaf.data, p)
        out = _chain_program(self.ring, key)(*[l.data for l in leaves])
        val = Poly(out, self.ring)
        # Memoize only concrete results: forcing inside an outer jit trace
        # yields tracers, and caching one would leak it out of the trace
        # (jax UnexpectedTracerError on the next access).
        if not isinstance(out, jax.core.Tracer):
            object.__setattr__(self, "_val", val)
        return val

    @property
    def data(self):
        return self.poly().data

    # --- lazy operators (stay lazy: extend the tree) ------------------------
    def __add__(self, other):
        return Expr("add", (self, _as_operand(other)))

    def __radd__(self, other):
        return Expr("add", (_as_operand(other), self))

    def __sub__(self, other):
        return Expr("sub", (self, _as_operand(other)))

    def __rsub__(self, other):
        return Expr("sub", (_as_operand(other), self))

    def __mul__(self, other):
        return Expr("mul", (self, _as_operand(other)))

    def __rmul__(self, other):
        return Expr("mul", (_as_operand(other), self))

    # --- forcing surface ----------------------------------------------------
    def __eq__(self, other):
        return self.poly() == other

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None

    def __bool__(self):
        return bool(self.poly())

    def __call__(self, cm: int, i: int) -> int:
        return self.poly()(cm, i)

    def __iter__(self):
        return iter(self.poly())

    def __repr__(self):
        leaves: list = []
        return f"Expr({self._flatten(leaves, {})!r}, nleaves={len(leaves)})"

    def __str__(self):
        return str(self.poly())

    def __getattr__(self, name):
        # forward the full Poly surface (ntt_pow_phi, mulmod, serialization…)
        # — but never dunders: protocol probes (copy/pickle/inspect) would
        # otherwise silently force evaluation and compile the whole chain.
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return getattr(self.poly(), name)


# Backwards-compatible name for the round-1 single-node expression type.
MulExpr = Expr


def _as_operand(x):
    """Poly or Expr, unforced (for building lazy trees)."""
    if isinstance(x, (Poly, Expr)):
        return x
    raise TypeError(f"expected Poly, got {type(x)!r}")


def _as_poly(x) -> Poly:
    if isinstance(x, Poly):
        return x
    if isinstance(x, Expr):
        return x.poly()
    raise TypeError(f"expected Poly, got {type(x)!r}")


def shoup(expr, prec) -> Expr:
    """nfl::shoup(a * b, bprec) -> fused mulmod_shoup (ops.hpp:267-277).

    Only the product pattern is defined (using shoup on anything else is a
    static error in the reference, ops.hpp:153-163).  Returns a lazy Expr so
    the rewrite composes with surrounding chains."""
    if isinstance(expr, Expr) and expr.op == "mul":
        return Expr("shoup", expr.args + (_as_operand(prec),))
    raise TypeError("shoup() expects a deferred product a * b")


def compute_shoup(x) -> Poly:
    return _as_poly(x).compute_shoup()


# free functions (reference poly.hpp:314-332 nfl::add/sub/mul).  Like the
# reference's, add/sub return the deferred expression (an Expr here).
def add(a, b) -> "Expr":
    return _as_poly(a) + b


def sub(a, b) -> "Expr":
    return _as_poly(a) - b


def mul(a, b) -> Poly:
    return _as_poly(a).mulmod(b)
