"""Test configuration.

Tests run on CPU with an 8-device virtual mesh for sharding tests, mirroring
the reference's CI approach of running one differential test matrix across
engines (reference .travis.yml:16-25, tests/CMakeLists.txt:1-7).  The GPU
path is exercised by chip_smoke.py, not by this suite.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import nfllib_tpu as nfl  # noqa: E402

# The reference's 5-point config matrix (tests/CMakeLists.txt:1-7):
# (degree, aggregated modulus bits, limb)
CONFIG_MATRIX_FULL = [
    (8, 60, "u32"),
    (128, 14, "u16"),
    (1024, 60, "u32"),
    (8192, 124, "u64"),
    (32768, 124, "u64"),
]

# Fast default matrix: same limb/modulus coverage, large-degree u64 points
# shrunk (emulated 64-bit CPU math is slow); the full reference points run
# under the `slow` marker.
CONFIG_MATRIX = [
    (8, 60, "u32"),
    (128, 14, "u16"),
    (1024, 60, "u32"),
    (512, 124, "u64"),
]

# Smaller matrix for O(n^2)-oracle tests
SMALL_MATRIX = [
    (8, 60, "u32"),
    (128, 14, "u16"),
    (64, 60, "u32"),
    (32, 124, "u64"),
]


def make_ring(degree, agg_bits, limb):
    return nfl.ring_from_modulus(limb, degree, agg_bits)


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def rand_residues(ring, rng, batch=()):
    """Random canonical residues < p, as numpy [batch..., m, n]."""
    m, n = ring.nmoduli, ring.degree
    out = np.empty(tuple(batch) + (m, n), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        out[..., cm, :] = rng.integers(0, p, size=tuple(batch) + (n,),
                                       dtype=np.uint64)
    return out.astype(ring.dtype)
