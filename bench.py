"""Benchmark — forward RNS-NTT throughput on one GPU.

Measures per-modulus negacyclic forward NTTs per second at n = 2^14 with
17 x 30-bit moduli (510 bits of modulus, >= the reference's 8 x 62-bit u64
config at tests/CMakeLists.txt:7), batch 64: one jitted ntt_pow_phi over a
[64, 17, 2^14] uint32 array.

Timing: warm-up calls (compilation excluded), then back-to-back calls ended
by block_until_ready.  Prints the card's name and power limit, then ONE JSON
line {"metric", "value", "unit", "device"}.  Exits nonzero without a GPU.
"""
from __future__ import annotations

import json
import sys

import numpy as np


def main() -> int:
    import jax

    import nfllib_tpu as nfl
    from nfllib_tpu import runtime
    from nfllib_tpu.ops import ntt
    from nfllib_tpu.profiling import time_call

    runtime.enable_compile_cache()
    runtime.require_gpu()
    print(runtime.card_identity(), flush=True)

    n, m, batch = 1 << 14, 17, 64
    ring = nfl.Ring("u32", n, m)
    ctx = ring.context()
    rng = np.random.default_rng(42)
    x = np.empty((batch, m, n), dtype=np.uint32)
    for cm in range(m):
        x[:, cm, :] = rng.integers(0, int(ring.moduli[cm]), size=(batch, n),
                                   dtype=np.uint32)
    fwd = jax.jit(lambda v: ntt.ntt_pow_phi(v, ctx))
    t = time_call(fwd, jax.device_put(x), warmup=3, reps=50)
    rate = batch * m / t["pipelined"]
    print(f"[bench] {batch * m} channel-NTTs (n={n}, m={m}): "
          f"{t['pipelined'] * 1e6:.1f} us per application back to back, "
          f"{t['median'] * 1e6:.1f} us single-call median", file=sys.stderr)
    print(json.dumps({
        "metric": "rns_ntt_n2pow14_per_sec_per_chip",
        "value": rate,
        "unit": "ntt/s",
        "device": runtime.device_record(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
