"""Per-primitive microbenchmarks — the reference's runtime benchmark harness
(tests/nfllib_demo_main_op.cpp:119-258) re-created for this library: prints
"us per operation" for every primitive at each config of the reference's
5-point matrix (tests/CMakeLists.txt:1-7).

Device ops are jitted and timed back to back after warm-up, ended by
block_until_ready (profiling.time_call).  Host sampling ops are timed
directly.  Exits nonzero without a GPU.

Usage: python tools/bench_ops.py [--config N] [--csv] [--trace DIR]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nfllib_tpu as nfl  # noqa: E402
from nfllib_tpu import profiling, runtime  # noqa: E402
from nfllib_tpu.apps import lwe  # noqa: E402
from nfllib_tpu.ops import modops, ntt as ntt_mod  # noqa: E402
from nfllib_tpu.prng.salsa20 import Salsa20Stream  # noqa: E402
from nfllib_tpu.prng.gaussian import FastGaussianNoise  # noqa: E402
from nfllib_tpu.prng import sampling  # noqa: E402

CONFIGS = [
    (8, 60, "u32"),
    (128, 14, "u16"),
    (1024, 60, "u32"),
    (8192, 124, "u64"),
    (32768, 124, "u64"),
]

BATCH = 8   # polys per device op


def _rand(ring, rng, batch=BATCH):
    m, n = ring.nmoduli, ring.degree
    out = np.empty((batch, m, n), dtype=np.uint64)
    for cm in range(m):
        out[:, cm, :] = rng.integers(0, int(ring.moduli[cm]),
                                     size=(batch, n), dtype=np.uint64)
    return out.astype(ring.dtype)


def _time_device(fn_one, x):
    """us per application of fn_one to x, back to back after warm-up."""
    return profiling.time_call(jax.jit(fn_one), x)["pipelined"] * 1e6


def _time_host(fn, reps=20):
    """us per call, best-of-reps (profiling.WallTimer is the chrono-style
    accumulator mirroring reference tests/tools.h:28-33)."""
    best = float("inf")
    for _ in range(reps):
        t = profiling.WallTimer()
        with t.measure():
            fn()
        best = min(best, t.mean_us)
    return best


def bench_config(degree, agg, limb, csv=False):
    ring = nfl.ring_from_modulus(limb, degree, agg)
    ctx = ring.context()
    rng = np.random.default_rng(7)
    p_col = jnp.asarray(ctx.p_col)
    pn_col = jnp.asarray(ctx.pn_col)
    a = jnp.asarray(_rand(ring, rng))
    b = jnp.asarray(_rand(ring, rng))
    bprec = jax.jit(lambda v: modops.compute_shoup(v, p_col))(b)

    rows = []

    def rec(name, us):
        # per-poly figure (batch-normalized), matching the reference's
        # single-poly loop numbers
        rows.append((name, us / BATCH))

    rec("add", _time_device(lambda v: modops.addmod(v, b, p_col), a))
    rec("sub", _time_device(lambda v: modops.submod(v, b, p_col), a))
    rec("mul (pointwise)",
        _time_device(lambda v: modops.mulmod(v, b, p_col, pn_col), a))
    rec("mulmod_shoup",
        _time_device(lambda v: modops.mulmod_shoup(v, b, bprec, p_col), a))
    rec("muladd (fma)",
        _time_device(lambda v: modops.muladd(v, a, b, p_col, pn_col), a))
    rec("muladd_shoup",
        _time_device(lambda v: modops.muladd_shoup(v, a, b, bprec, p_col),
                     a))
    rec("ntt_pow_phi", _time_device(lambda v: ntt_mod.ntt_pow_phi(v, ctx), a))
    rec("invntt_pow_invphi",
        _time_device(lambda v: ntt_mod.invntt_pow_invphi(v, ctx), a))

    # end-to-end LWE chains (reference demo encrypt/decrypt timing,
    # nfllib_demo_main_op.cpp:292-311)
    stream = Salsa20Stream(b"\x11" * 32)
    g = lwe.make_gaussian_prng(samples=max(degree, 1 << 10))
    keys = lwe.keygen(ring, stream, g)
    e2 = jnp.asarray(_rand(ring, rng))
    rec("lwe encrypt (chain)", _time_device(
        lambda v: lwe._encrypt_graph(ctx, keys.pka.data, keys.pkb.data,
                                     v, b, e2)[0], a))
    resa, resb = jax.jit(lambda u: lwe._encrypt_graph(
        ctx, keys.pka.data, keys.pkb.data, u, b, e2))(a)
    rec("lwe decrypt (chain)", _time_device(
        lambda v: lwe._decrypt_graph(ctx, v, resb, keys.s.data,
                                     keys.sprime.data), resa))

    # host sampling (per poly)
    s = Salsa20Stream(b"\x13" * 32)
    rows.append(("uniform (host)",
                 _time_host(lambda: sampling.sample_uniform(ring, s))))
    rows.append(("non_uniform ub=7 (host)", _time_host(
        lambda: sampling.sample_non_uniform(ring, s,
                                            sampling.non_uniform(7)))))
    fg = FastGaussianNoise(4.0, 128, max(degree, 1024))
    rows.append(("gaussian (host)", _time_host(
        lambda: sampling.sample_gaussian(ring, s, sampling.gaussian(fg)),
        reps=5)))

    hdr = f"== n={degree} {agg}-bit {limb} (batch={BATCH}, " \
          f"device={jax.devices()[0].device_kind}) =="
    print(hdr)
    for name, us in rows:
        if csv:
            print(f"{degree},{agg},{limb},{name},{us:.3f}")
        else:
            print(f"  {name:26s} {us:12.3f} us/poly")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=None,
                    help="index into the 5-point matrix (default: all)")
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="capture a jax.profiler device trace to DIR "
                         "(view with TensorBoard/XProf)")
    args = ap.parse_args()
    runtime.enable_compile_cache()
    runtime.require_gpu()
    print(runtime.card_identity())
    cfgs = CONFIGS if args.config is None else [CONFIGS[args.config]]

    def run_all():
        for degree, agg, limb in cfgs:
            with profiling.annotate(f"bench_n{degree}_{limb}"):
                bench_config(degree, agg, limb, csv=args.csv)

    if args.trace:
        with profiling.trace(args.trace):
            run_all()
    else:
        run_all()


if __name__ == "__main__":
    main()
