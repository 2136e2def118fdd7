"""Run the library's main path once on the GPU and check every result.

    python chip_smoke.py           # one card: identity, ntt, u64, expr, lwe
    python chip_smoke.py --four    # four cards: identity and the sharded paths

The phases run in order through the public API (nfl.Ring, nfl.Poly,
ops.ntt, apps.lwe, parallel.ntt_dist), at full width.  Each prints one line
of findings; any failure ends the run with a nonzero exit.  The last line is
one JSON object naming the device.  Without a GPU the run exits nonzero
before it computes anything.

Precision: every check is exact integer equality.  The device path holds no
floating-point operation: the only float arithmetic of the samplers
(gaussian.py, device_sampling.py) runs on the host in numpy, so TF32 cannot
enter a result.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np

FLAGSHIP = dict(degree=1 << 14, nmoduli=17, batch=64)
U64 = dict(degree=32768, agg_bits=124, batch=128, big_degree=1 << 20,
           big_nmoduli=2)
FOUR = dict(degree=1 << 20, nmoduli=2, batch=8, lwe_batch=8)


_T0 = time.perf_counter()


def _say(phase: str, text: str) -> None:
    print(f"[{phase} +{time.perf_counter() - _T0:.1f}s] {text}", flush=True)


def _mb(nbytes: int) -> str:
    return f"{nbytes / 1e6:.1f} MB"


def rand_residues(ring, batch, seed: int):
    """Uniform canonical residues [batch..., m, n] in the ring's dtype."""
    rng = np.random.default_rng(seed)
    x = np.empty(tuple(batch) + ring.shape, dtype=ring.dtype)
    for cm in range(ring.nmoduli):
        x[..., cm, :] = rng.integers(0, int(ring.moduli[cm]),
                                     size=tuple(batch) + (ring.degree,),
                                     dtype=np.uint64)
    return x


_TRIVIAL = {"parameter", "constant", "get-tuple-element", "tuple", "bitcast"}


def hlo_kernel_counts(hlo_text: str) -> dict:
    """Operations of the ENTRY computation of an optimized HLO module that
    launch device work: {"kernels": all such ops, "fusions": the fusion ops
    among them}.  Parameters, constants, tuples and bitcasts are free."""
    ops = []
    in_entry = False
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            in_entry = True
            continue
        if in_entry:
            if line.startswith("}"):
                break
            m = re.search(r"=\s+(?:\([^=]*?\)|\S+)\s+([a-z][\w\-]*)\(", line)
            if m and m.group(1) not in _TRIVIAL:
                ops.append(m.group(1))
    return {"kernels": len(ops), "fusions": ops.count("fusion")}


def collective_counts(hlo_text: str) -> dict:
    """Transpose collectives in an optimized HLO module (sync or async)."""
    def count(op):
        return len(re.findall(rf"\s{op}(?:-start)?\(", hlo_text))
    return {"all_to_all": count("all-to-all"),
            "collective_permute": count("collective-permute")}


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis n/a"
    return (f"memory_analysis args={_mb(m.argument_size_in_bytes)} "
            f"out={_mb(m.output_size_in_bytes)} "
            f"temp={_mb(m.temp_size_in_bytes)} "
            f"code={_mb(m.generated_code_size_in_bytes)}")


def _peak(dev) -> str:
    stats = dev.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "peak_bytes_in_use n/a"
    return f"peak_bytes_in_use={_mb(stats['peak_bytes_in_use'])}"


def _compile(fn, *args):
    """(compiled, seconds) for jax.jit(fn) at these arguments."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _equal(a, b) -> bool:
    import jax.numpy as jnp
    return bool(jnp.array_equal(a, b))


def _cpu_matches(fn, x_host, got) -> bool:
    """fn on the CPU backend at x_host equals `got` bit for bit."""
    import jax
    cpu = jax.devices("cpu")[0]
    want = jax.jit(fn)(jax.device_put(x_host, cpu))
    return bool(np.array_equal(np.asarray(got), np.asarray(want)))


def phase_ntt(card: str, degree: int, nmoduli: int, batch: int,
              check_degree: int = 1024, reps: int = 10) -> dict:
    """u32 forward/inverse transform at the flagship ring: round trip over
    the batch, GPU against CPU on element 0, a pointwise product against
    the schoolbook oracle, compile and memory figures, kernel count of the
    forward program, and its warm time beside a copy pass of the array."""
    import jax
    import jax.numpy as jnp

    import nfllib_tpu as nfl
    from nfllib_tpu import oracle
    from nfllib_tpu.ops import ntt
    from nfllib_tpu.profiling import time_call

    dev = jax.devices()[0]
    ring = nfl.Ring("u32", degree, nmoduli)
    ctx = ring.context()
    x_host = rand_residues(ring, (batch,), seed=1)
    x = jax.device_put(x_host, dev)

    def fwd(v):
        return ntt.ntt_pow_phi(v, ctx)

    def inv(v):
        return ntt.invntt_pow_invphi(v, ctx)

    cfwd, t_compile = _compile(fwd, x)
    counts = hlo_kernel_counts(cfwd.as_text())
    y = cfwd(x)
    assert _equal(jax.jit(inv)(y), x), "ntt round trip is not bit-exact"
    assert _cpu_matches(fwd, x_host[0], y[0]), "GPU forward != CPU forward"

    small = nfl.ring_from_modulus("u32", check_degree, 60)
    a = rand_residues(small, (), seed=2)
    b = rand_residues(small, (), seed=3)
    prod = (nfl.Poly(jnp.asarray(a), small).ntt_pow_phi()
            .mulmod(nfl.Poly(jnp.asarray(b), small).ntt_pow_phi())
            .invntt_pow_invphi())
    assert np.array_equal(np.asarray(prod.data),
                          oracle.negacyclic_mul_schoolbook(a, b, small)), \
        "NTT-domain product != schoolbook product"

    t_fwd = time_call(cfwd, x, reps=reps)
    ccopy, _ = _compile(lambda v: v ^ jnp.ones((), v.dtype), x)
    t_copy = time_call(ccopy, x, reps=reps)
    ratio = t_fwd["pipelined"] / t_copy["pipelined"]
    copy_gbs = 2 * x_host.nbytes / t_copy["pipelined"] / 1e9
    _say("ntt", f"u32 n={degree} m={nmoduli} batch={batch} "
         f"({_mb(x_host.nbytes)}): round trip bit-exact; GPU==CPU on "
         f"element 0; product==schoolbook (n={check_degree}, m=2); "
         f"compile {t_compile:.2f} s; {_memory(cfwd)}; {_peak(dev)}; "
         f"forward program: {counts['kernels']} kernels, "
         f"{counts['fusions']} fusions; forward "
         f"{t_fwd['pipelined']*1e3:.3f} ms/application pipelined, "
         f"{t_fwd['median']*1e3:.3f} ms single-call median of {reps}; "
         f"copy pass (x^1) {t_copy['pipelined']*1e3:.3f} ms pipelined "
         f"({copy_gbs:.0f} GB/s read+write), {t_copy['median']*1e3:.3f} ms "
         f"single-call; forward/copy {ratio:.1f}x; card: {card}")
    return {"compile_s": t_compile, "forward_s": t_fwd["pipelined"],
            "copy_s": t_copy["pipelined"], **counts}


def phase_u64(card: str, degree: int, agg_bits: int, batch: int,
              big_degree: int, big_nmoduli: int, reps: int = 5) -> dict:
    """62-bit tier: round trip and GPU==CPU at the reference matrix's
    largest point, then a round trip at the largest degree on one card."""
    import jax

    import nfllib_tpu as nfl
    from nfllib_tpu.ops import ntt
    from nfllib_tpu.profiling import time_call

    dev = jax.devices()[0]
    out = {}
    for name, ring, nb in (
            ("matrix", nfl.ring_from_modulus("u64", degree, agg_bits), batch),
            ("large", nfl.Ring("u64", big_degree, big_nmoduli), 1)):
        ctx = ring.context()
        x_host = rand_residues(ring, (nb,), seed=4)
        x = jax.device_put(x_host, dev)

        def fwd(v, ctx=ctx):
            return ntt.ntt_pow_phi(v, ctx)

        def inv(v, ctx=ctx):
            return ntt.invntt_pow_invphi(v, ctx)

        cfwd, t_compile = _compile(fwd, x)
        cinv, t_compile_inv = _compile(inv, cfwd(x))
        y = cfwd(x)
        assert _equal(cinv(y), x), f"u64 {name} round trip is not bit-exact"
        note = ""
        if name == "matrix":
            assert _cpu_matches(fwd, x_host[0], y[0]), \
                "u64 GPU forward != CPU forward"
            note = "GPU==CPU on element 0; "
        t = time_call(cfwd, x, reps=reps)
        _say("u64", f"{name}: n={ring.degree} m={ring.nmoduli} batch={nb} "
             f"({_mb(x_host.nbytes)}): round trip bit-exact; {note}compile "
             f"fwd {t_compile:.2f} s inv {t_compile_inv:.2f} s; "
             f"{_memory(cfwd)}; forward {t['pipelined']*1e3:.3f} ms"
             f"/application pipelined, {t['median']*1e3:.3f} ms single-call "
             f"median of {reps}; card: {card}")
        out[name] = {"compile_s": t_compile, "forward_s": t["pipelined"]}
    return out


def phase_expr(degree: int, nmoduli: int) -> dict:
    """The lazy tree shoup(fa * fb, bprec) + c - d through Poly/Expr,
    against numpy uint64 arithmetic."""
    import nfllib_tpu as nfl
    from nfllib_tpu.prng.salsa20 import Salsa20Stream

    ring = nfl.Ring("u32", degree, nmoduli)
    stream = Salsa20Stream(b"\x04" * 32)
    a, b, c, d = (nfl.Poly.sample(ring, nfl.uniform(), stream)
                  for _ in range(4))
    fa, fb = a.ntt_pow_phi(), b.ntt_pow_phi()
    bprec = nfl.compute_shoup(fb)
    got = np.asarray((nfl.shoup(fa * fb, bprec) + c - d).poly().data)

    p = np.asarray(ring.moduli, dtype=np.uint64)[:, None]
    fa_, fb_, c_, d_ = (np.asarray(v.data).astype(np.uint64)
                        for v in (fa, fb, c, d))
    want = ((fa_ * fb_ % p + c_) % p + p - d_) % p
    assert np.array_equal(got.astype(np.uint64), want), \
        "Expr chain != numpy reference"
    _say("expr", f"shoup(fa * fb, bprec) + c - d on u32 n={degree} "
         f"m={nmoduli}: bit-exact against numpy uint64")
    return {}


def phase_lwe(degree: int, nmoduli: int, repetitions: int = 10,
              nonces: int = 4) -> dict:
    """The LWE app: the zero-sum gate, then device encryption (stream-exact
    sampler) against host encryption at the same (key, nonce)."""
    from nfllib_tpu import Ring
    from nfllib_tpu.apps import lwe
    from nfllib_tpu.prng.salsa20 import Salsa20Stream

    ring = Ring("u32", degree, nmoduli)
    t0 = time.perf_counter()
    assert lwe.run_zero_sum_check(ring, repetitions=repetitions,
                                  key=b"\x05" * 32), \
        "decryptions of encryptions of zero do not sum to 0"
    t_gate = time.perf_counter() - t0

    key = b"\x06" * 32
    g = lwe.make_gaussian_prng()
    stream = Salsa20Stream(key)
    keys = lwe.keygen(ring, stream, g)
    t_host = t_dev = 0.0
    t_first = None
    for i in range(nonces):
        nonce = stream.nonce
        t0 = time.perf_counter()
        ha, hb = lwe.encrypt(keys, ring, stream, g)
        ha.data.block_until_ready()
        t1 = time.perf_counter()
        da, db = lwe.encrypt_on_device(keys, ring, key, nonce, g, exact=True)
        da.data.block_until_ready()
        if i:                       # the first call of each compiles
            t_host += t1 - t0
            t_dev += time.perf_counter() - t1
        else:
            t_first = (t1 - t0, time.perf_counter() - t1)
        assert _equal(ha.data, da.data) and _equal(hb.data, db.data), \
            f"device encryption != host encryption at nonce {nonce}"
        for ra, rb in ((ha, hb), (da, db)):
            assert not np.any(np.asarray(lwe.decrypt(keys, ring, ra, rb))), \
                f"encryption at nonce {nonce} does not decrypt to zero"
    warm = max(nonces - 1, 1)
    _say("lwe", f"u32 n={degree} m={nmoduli}: zero-sum gate over "
         f"{repetitions} encryptions exact ({t_gate:.2f} s with compile); "
         f"encrypt_on_device(exact=True) == host encrypt at {nonces} "
         f"nonces, all decrypt to 0; warm encrypt host-sampled "
         f"{t_host / warm * 1e3:.2f} ms, on-device {t_dev / warm * 1e3:.2f} "
         f"ms (first calls, with compile: {t_first[0]:.2f} s, "
         f"{t_first[1]:.2f} s)")
    return {"gate_s": t_gate}


def phase_four_ntt(devices, card: str, degree: int, nmoduli: int,
                   batch: int, reps: int = 5) -> dict:
    """u64 deg-sharded four-step transform over a (1, 1, 4) mesh, every
    transpose variant, against the single-card Harvey transform."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import nfllib_tpu as nfl
    from nfllib_tpu.ops import ntt
    from nfllib_tpu.parallel import ntt_dist
    from nfllib_tpu.profiling import time_call
    from nfllib_tpu.utils import bitrev_indices, static_log2

    d = len(devices)
    mesh = Mesh(np.array(devices).reshape(1, 1, d), ("batch", "rns", "deg"))
    ring = nfl.Ring("u64", degree, nmoduli)
    ctx = ring.context()
    x_host = rand_residues(ring, (batch,), seed=5)
    x0 = jax.device_put(x_host, devices[0])
    charvey, _ = _compile(lambda v: ntt.ntt_pow_phi(v, ctx), x0)
    harvey = np.asarray(charvey(x0))
    t_one = time_call(charvey, x0, reps=reps)
    _say("four", f"single-card Harvey u64 n={degree} m={nmoduli} "
         f"batch={batch} on device 0: forward "
         f"{t_one['pipelined']*1e3:.3f} ms pipelined over {reps} calls; "
         f"card: {card}")
    rev = bitrev_indices(degree)
    n1 = 1 << (static_log2(degree) // 2)
    n2 = degree // n1
    xd = jax.device_put(x_host, NamedSharding(mesh, P(None, None, "deg")))

    # The input is deg-sharded in natural order (contiguous blocks of n);
    # the four-step wants column shards, so every variant first reshards
    # it.  That layout collective is the ppermute variant's all-to-all
    # count, and each a2a variant adds one all-to-all per chunk on top.
    variants = (("ppermute", dict(transpose="ppermute"), 0),
                ("a2a", dict(transpose="a2a"), 1),
                ("a2a chunks=2", dict(transpose="a2a", chunks=2), 2))
    times = {}
    layout = None
    for name, kw, extra_a2a in variants:
        cf, tc_f = _compile(lambda v, kw=kw: ntt_dist.distributed_ntt_pow_phi(
            v, ring, mesh, **kw), xd)
        y = cf(xd)
        ci, tc_i = _compile(
            lambda v, kw=kw: ntt_dist.distributed_invntt_pow_invphi(
                v, ring, mesh, **kw), y)
        coll = {"forward": collective_counts(cf.as_text()),
                "inverse": collective_counts(ci.as_text())}
        if layout is None:
            layout = {k: c["all_to_all"] for k, c in coll.items()}
            assert all(c["collective_permute"] >= d - 1
                       for c in coll.values()), f"{name}: {coll}"
        for k, c in coll.items():
            assert c["all_to_all"] == layout[k] + extra_a2a, \
                f"{name} {k}: {c} (layout all-to-alls {layout[k]})"
        e = np.asarray(y).swapaxes(-1, -2).reshape(x_host.shape)
        assert np.array_equal(e[..., rev], harvey), \
            f"four-step {name} != single-card Harvey"
        assert np.array_equal(np.asarray(ci(y)), x_host), \
            f"four-step {name} round trip is not bit-exact"
        t_f = time_call(cf, xd, reps=reps)
        t_i = time_call(ci, y, reps=reps)
        times[name] = (t_f["pipelined"], t_i["pipelined"])
        _say("four", f"deg-sharded u64 n={degree} m={nmoduli} batch={batch} "
             f"({_mb(x_host.nbytes)}) over {d} devices, {name} (n1={n1}, "
             f"n2={n2}): == single-card Harvey, round trip bit-exact; "
             f"collectives {coll}; compile fwd {tc_f:.2f} s inv "
             f"{tc_i:.2f} s; forward {t_f['pipelined']*1e3:.3f} ms, inverse "
             f"{t_i['pipelined']*1e3:.3f} ms pipelined over {reps} calls "
             f"(single-call medians {t_f['median']*1e3:.3f} / "
             f"{t_i['median']*1e3:.3f} ms); card: {card}")
    return times


def phase_four_lwe(devices, degree: int, nmoduli: int, batch: int) -> dict:
    """The LWE encrypt+decrypt step sharded over a (2, 2, 1)
    ("batch", "rns", "deg") mesh: every shard decodes exactly zero."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import nfllib_tpu as nfl
    from nfllib_tpu.apps import lwe
    from nfllib_tpu.prng.salsa20 import Salsa20Stream

    mesh = Mesh(np.array(devices).reshape(2, 2, 1), ("batch", "rns", "deg"))
    ring = nfl.Ring("u32", degree, nmoduli)
    ctx = ring.context()
    stream = Salsa20Stream(b"\x09" * 32)
    g = lwe.make_gaussian_prng()
    keys = lwe.keygen(ring, stream, g)

    def noise(mode):
        return np.stack([np.asarray(nfl.Poly.sample(ring, mode, stream).data)
                         for _ in range(batch)])

    u, e1, e2 = noise(nfl.gaussian(g)), noise(nfl.gaussian(g, 2)), \
        noise(nfl.gaussian(g, 2))
    sh_b = NamedSharding(mesh, P("batch", "rns", None))
    sh_k = NamedSharding(mesh, P("rns", None))

    def step(pka, pkb, s, sprime, u, e1, e2):
        resa, resb = lwe._encrypt_graph(ctx, pka, pkb, u, e1, e2)
        return lwe._decrypt_graph(ctx, resa, resb, s, sprime)

    jstep = jax.jit(step, in_shardings=(sh_k,) * 4 + (sh_b,) * 3)
    bits = jstep(keys.pka.data, keys.pkb.data, keys.s.data, keys.sprime.data,
                 jnp.asarray(u), jnp.asarray(e1), jnp.asarray(e2))
    shards = bits.addressable_shards
    assert len({s.device for s in shards}) == len(devices)
    assert all(not np.any(np.asarray(s.data)) for s in shards), \
        "a shard of the sharded LWE step does not decode to zero"
    _say("four", f"LWE encrypt+decrypt u32 n={degree} m={nmoduli} "
         f"batch={batch} sharded (2, 2, 1) batch x rns: all "
         f"{len(shards)} shards decode exactly 0")
    return {}


def run_one_card(card: str, flagship=FLAGSHIP, u64=U64) -> None:
    phase_ntt(card, **flagship)
    phase_u64(card, **u64)
    phase_expr(flagship["degree"], flagship["nmoduli"])
    phase_lwe(flagship["degree"], flagship["nmoduli"])


def run_four(devices, card: str, four=FOUR, lwe_nmoduli: int = 18) -> None:
    """lwe_nmoduli: the flagship's 17 channels rounded up to split evenly
    over the rns axis."""
    phase_four_ntt(devices, card, four["degree"], four["nmoduli"],
                   four["batch"])
    phase_four_lwe(devices, FLAGSHIP["degree"], lwe_nmoduli,
                   four["lwe_batch"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    import jax

    from nfllib_tpu import runtime

    runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    card = runtime.card_identity()
    record = runtime.device_record()
    _say("identity", f"platform={dev.platform} kind={dev.device_kind} "
         f"count={record['count']}")
    print(card, flush=True)
    if args.four:
        devices = jax.devices()
        if len(devices) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
        run_four(devices[:4], card)
    else:
        run_one_card(card)
    print(json.dumps({"ok": True, "device": record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
