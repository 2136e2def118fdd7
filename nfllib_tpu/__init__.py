"""nfllib_tpu — ideal-lattice polynomial arithmetic in JAX.

A JAX/XLA library with the capabilities of quarkslab/NFLlib
(reference mounted at /root/reference): negacyclic NTT over power-of-two
cyclotomic rings in CRT/RNS form, fused modular elementwise ops, cryptographic
sampling (Salsa20 stream PRNG; uniform / bounded / ternary / Hamming-weight /
discrete-Gaussian polynomial generators), CRT lifting to big integers, and
NFLlib-compatible serialization.  Residue channels and batches shard over
device meshes, and XLA fusion replaces expression templates.

Exact 62-bit limb arithmetic requires 64-bit integer support, so x64 mode is
enabled at import (before any tracing).
"""
from jax import config as _jax_config

_jax_config.update("jax_enable_x64", True)

from .params import LIMBS, LimbParams, get_limb_params          # noqa: E402
from .ring import Ring, RingContext, get_context, ring_from_modulus  # noqa: E402
from .poly import (                                              # noqa: E402
    Poly,
    PolyP,
    add,
    compute_shoup,
    gaussian,
    hwt_dist,
    mul,
    non_uniform,
    shoup,
    sub,
    uniform,
    ZO_dist,
)
from .crt import mpz2poly, poly2mpz, set_mpz                     # noqa: E402

# type-alias parity (reference poly.hpp:336-337, poly_p.hpp:208-209): ring
# configs play the role of the reference's compile-time poly types
poly_from_modulus = ring_from_modulus
poly_p_from_modulus = ring_from_modulus

__all__ = [
    "PolyP",
    "add",
    "sub",
    "mul",
    "mpz2poly",
    "poly2mpz",
    "set_mpz",
    "poly_from_modulus",
    "poly_p_from_modulus",
    "LIMBS",
    "LimbParams",
    "get_limb_params",
    "Ring",
    "RingContext",
    "get_context",
    "ring_from_modulus",
    "Poly",
    "uniform",
    "non_uniform",
    "hwt_dist",
    "ZO_dist",
    "gaussian",
    "shoup",
    "compute_shoup",
]

__version__ = "0.1.0"
