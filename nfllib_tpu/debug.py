"""Strict-mod debug checks (reference include/nfl/debug.hpp).

The reference's CHECK_STRICTMOD compiles range-contract assertions into every
modular op (debug.hpp:33-37, ops.hpp:131,148,190,211 ...).  Here the
equivalent is a global flag that inserts jax.debug (host-callback) or eager
assertions validating residues < p at op boundaries.  NTT_STRICTMOD (the final
reduction to [0, p), debug.hpp:31) is always on, as in the reference.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_STRICT = os.environ.get("NFL_STRICTMOD", "0") not in ("0", "", "false")


def set_strictmod(enabled: bool) -> None:
    global _STRICT
    _STRICT = bool(enabled)


def strictmod_enabled() -> bool:
    return _STRICT


def _raise_oob(ok_val):
    if not ok_val:
        raise AssertionError("STRICTMOD: residue out of [0, p) range")


def check_residues(data, p_col) -> None:
    """Assert all residues < p (per channel).  No-op unless strict mode.

    Works both eagerly (raises AssertionError immediately) and under jit
    (jax.debug.callback — the AssertionError surfaces wrapped in the runtime
    error at result time)."""
    if not _STRICT:
        return
    ok = jnp.all(data < p_col)
    if isinstance(ok, jax.core.Tracer):
        jax.debug.callback(_raise_oob, ok)
    else:
        _raise_oob(bool(ok))


def op_check(p, *operands) -> None:
    """Per-op strict-mod operand bracket (reference debug.hpp:33-37).

    The reference compiles `assert x < p` into every modular functor
    (ops.hpp:131,148,190,211).  modops calls this at each op entry so strict
    mode brackets every intermediate, not just Poly operator boundaries.
    No-op (not even traced) unless strict mode is on at trace time — callers
    caching jitted programs must key the cache on strictmod_enabled()."""
    if not _STRICT:
        return
    for d in operands:
        check_residues(d, p)
