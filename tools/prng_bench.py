"""Gaussian sampler statistical harness — the reference's prng_demo_main
(tests/prng_demo_main.cpp:6-35: 5*10^7 samples, cycles/bit, sample dump for
offline distribution checks) re-created for this library.

Usage: python tools/prng_bench.py [--samples N] [--dump FILE] [--sigma S]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from nfllib_tpu.prng.gaussian import FastGaussianNoise  # noqa: E402
from nfllib_tpu.prng.salsa20 import Salsa20Stream  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=50_000_000)
    ap.add_argument("--sigma", type=float, default=4.0)
    ap.add_argument("--security", type=int, default=128)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()

    t0 = time.perf_counter()
    fg = FastGaussianNoise(args.sigma, args.security, max(args.samples, 1024))
    print(f"table build: {time.perf_counter() - t0:.2f}s "
          f"({fg.number_of_barriers} barriers, {fg.bit_precision} bits)")

    stream = Salsa20Stream.from_system_entropy()
    chunk = 5_000_000
    total = 0
    s1 = s2 = 0.0
    outliers = 0
    t0 = time.perf_counter()
    dump = open(args.dump, "wb") if args.dump else None
    while total < args.samples:
        k = min(chunk, args.samples - total)
        out = fg.get_noise(stream, k)
        total += k
        s1 += float(out.sum())
        s2 += float((out.astype(np.float64) ** 2).sum())
        outliers += int(np.count_nonzero(np.abs(out) > 6 * args.sigma + 1))
        if dump:
            dump.write(out.astype("<i8").tobytes())
    dt = time.perf_counter() - t0
    if dump:
        dump.close()

    mean = s1 / total
    std = (s2 / total - mean * mean) ** 0.5
    print(f"{total} samples in {dt:.2f}s -> {total/dt/1e6:.2f} Msamples/s")
    print(f"mean {mean:+.5f} (expect 0)   std {std:.5f} "
          f"(expect {args.sigma})   >6-sigma outliers: {outliers} "
          f"(~{total * 2e-9:.1f} expected)")


if __name__ == "__main__":
    main()
