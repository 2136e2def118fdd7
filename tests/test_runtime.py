"""Run-time set-up for GPU scripts: compile-cache placement, the device
check, and bench.py's refusal to report a number off the GPU."""
import os
import pathlib
import subprocess
import sys

import jax
import pytest

from nfllib_tpu import runtime

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compile_cache_dir() == str(ROOT / ".jax_cache")
    assert runtime.compile_cache_dir() == runtime.compile_cache_dir()


def test_default_cache_dir_is_git_ignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_lands_in_the_named_directory(tmp_path):
    """A compile after enable_compile_cache() writes its entry there."""
    code = ("import jax, jax.numpy as jnp\n"
            "from nfllib_tpu import runtime\n"
            "runtime.enable_compile_cache()\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
            "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
            "jax.jit(lambda v: v * 3 + 1)(jnp.arange(8)).block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert any((tmp_path / "cache").iterdir())


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def test_device_record_names_the_backend():
    rec = runtime.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


@pytest.mark.parametrize("script", ["bench.py", "tools/bench_ops.py"])
def test_bench_refuses_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert "rns_ntt" not in r.stdout and "us/poly" not in r.stdout
