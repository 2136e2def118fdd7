"""Set-up for scripts that measure on the GPU (chip_smoke.py, bench.py).

Nothing here runs at library import: a script calls `enable_compile_cache()`
and `require_gpu()` first, before it compiles anything.
"""
from __future__ import annotations

import os
import pathlib
import subprocess

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else `<repo>/.jax_cache`.

    The default is a fixed path inside the checkout: the cache's key includes
    nothing that moves between runs, so a second run of the same checkout
    finds what the first compiled."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(REPO_ROOT / ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The default device, which must be a GPU; exits nonzero otherwise, so
    that no number measured on another device is reported as a GPU's."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {dev.platform!r} "
            f"({dev.device_kind}); nothing is measured on it")
    return dev


def device_record() -> dict:
    """{"platform", "kind", "count"} of the default backend, as JAX says."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_identity() -> str:
    """Each card's name and power limit as nvidia-smi reports them, read in a
    child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
