"""Executed multi-process distributed-NTT check.

Launches TWO OS processes on this host, each with 2 virtual CPU devices,
connects them through `parallel.api.init_distributed` (the framework's
multi-host entry point, exercised via its JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID environment path — exactly how a cluster
launcher would drive it), builds a 4-device cross-process mesh, and runs the
distributed four-step NTT (chunked forward AND inverse) on it:

  * forward output must be bit-identical to the mesh-free
    four_step_reference computed single-process on the same input;
  * the inverse roundtrip must return the input exactly;
  * the per-process addressable shards must be balanced.

This makes the multi-host entry REAL — the same jax.distributed runtime,
cross-process mesh construction, device_put of globally-sharded tables, and
shard_map collectives that a multi-host run would use, minus only the
physical interconnect (the collectives ride the in-host transport here).

Writes MULTIPROC.json at the repo root.

Run from the repo root: python tools/check_multiprocess.py
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

N_PROC = 2
DEV_PER_PROC = 2
PORT = 29517
LOG2N = 16
CHUNKS = 2


def child(proc_id: int) -> None:
    # pin CPU before any backend discovery: the children share the host's
    # CPU, never an accelerator
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

    import numpy as np

    sys.path.insert(0, str(ROOT))
    import nfllib_tpu as nfl
    from nfllib_tpu.parallel import api, ntt_dist

    # the env path: coordinator/process-count/id come from the environment
    # the parent set up, mirroring a pod launcher
    pidx, pcount = api.init_distributed()
    assert pidx == proc_id and pcount == N_PROC, (pidx, pcount)

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = jax.devices()
    assert len(devices) == N_PROC * DEV_PER_PROC, devices
    assert len(jax.local_devices()) == DEV_PER_PROC
    mesh = Mesh(np.array(devices).reshape(-1), axis_names=("deg",))

    ring = nfl.Ring("u64", 1 << LOG2N, 2)
    rng = np.random.default_rng(20260819)
    x = np.empty(ring.shape, dtype=ring.dtype)
    for cm in range(ring.nmoduli):
        x[cm] = rng.integers(0, int(ring.moduli[cm]), size=ring.degree)

    # global input array sharded over the degree axis across BOTH processes
    xg = jax.device_put(x, NamedSharding(mesh, P(None, "deg")))

    y = ntt_dist.distributed_ntt_pow_phi(xg, ring, mesh, chunks=CHUNKS)
    x2 = ntt_dist.distributed_invntt_pow_invphi(y, ring, mesh,
                                                chunks=CHUNKS)

    shard_shapes = {s.data.shape for s in y.addressable_shards}
    balanced = len(shard_shapes) == 1

    # replicate the distributed results so every process can compare the
    # full arrays against its local single-process reference
    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))
    y_full = np.asarray(rep(y).addressable_data(0))
    x2_full = np.asarray(rep(x2).addressable_data(0))

    n1 = 1 << (LOG2N // 2)
    want = np.asarray(ntt_dist.four_step_reference(jnp.asarray(x), ring, n1))
    fwd_ok = bool(np.array_equal(y_full, want))
    rt_ok = bool(np.array_equal(x2_full, x))

    print(json.dumps({"proc": proc_id, "fwd_matches_single_process": fwd_ok,
                      "roundtrip": rt_ok, "balanced_shards": balanced,
                      "global_devices": len(devices)}), flush=True)
    jax.distributed.shutdown()
    sys.exit(0 if (fwd_ok and rt_ok and balanced) else 1)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]))
        return 0

    env_base = {k: v for k, v in os.environ.items()}
    procs = []
    for i in range(N_PROC):
        env = dict(env_base)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count="
                              f"{DEV_PER_PROC}").strip()
        env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{PORT}"
        env["JAX_NUM_PROCESSES"] = str(N_PROC)
        env["JAX_PROCESS_ID"] = str(i)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--child", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=str(ROOT), text=True))

    results, rcs = [], []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        rcs.append(p.returncode)
        for line in out.splitlines():
            try:
                results.append(json.loads(line))
            except json.JSONDecodeError:
                pass
        if p.returncode != 0:
            sys.stderr.write(f"--- child {i} rc={p.returncode} stderr ---\n"
                             + err[-4000:] + "\n")

    ok = (rcs == [0] * N_PROC and len(results) == N_PROC
          and all(r["fwd_matches_single_process"] and r["roundtrip"]
                  and r["balanced_shards"] for r in results))
    artifact = {
        "ok": bool(ok),
        "processes": N_PROC,
        "devices_per_process": DEV_PER_PROC,
        "config": f"u64 n=2^{LOG2N} x 2ch, 4-device deg mesh, "
                  f"chunks={CHUNKS} fwd+inv",
        "entry": "parallel.api.init_distributed (env path)",
        "results": results,
        "return_codes": rcs,
    }
    (ROOT / "MULTIPROC.json").write_text(json.dumps(artifact, indent=1)
                                         + "\n")
    print(json.dumps({"multiprocess_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
