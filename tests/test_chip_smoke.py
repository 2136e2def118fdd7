"""chip_smoke.py's phases at tiny sizes on the CPU, its HLO readers, and
its refusal to report anything without a GPU."""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load()


def test_phase_ntt_small():
    out = smoke.phase_ntt("cpu", degree=64, nmoduli=2, batch=3,
                          check_degree=32, reps=2)
    assert out["kernels"] >= out["fusions"] >= 1


def test_phase_u64_small():
    out = smoke.phase_u64("cpu", degree=64, agg_bits=124, batch=2,
                          big_degree=1024, big_nmoduli=1, reps=1)
    assert set(out) == {"matrix", "large"}


def test_phase_expr_small():
    smoke.phase_expr(256, 3)


def test_phase_lwe_small():
    smoke.phase_lwe(256, 2, repetitions=2, nonces=2)


def test_phase_four_ntt_virtual_mesh():
    times = smoke.phase_four_ntt(jax.devices("cpu")[:4], "cpu", 1024, 2, 2,
                                 reps=1)
    assert set(times) == {"a2a", "ppermute", "a2a chunks=2"}


def test_phase_four_lwe_virtual_mesh():
    smoke.phase_four_lwe(jax.devices("cpu")[:4], 256, 2, 2)


_HLO = """HloModule m

fused_computation {
  p = u32[4]{0} parameter(0)
  ROOT a = u32[4]{0} add(p, p)
}

ENTRY main {
  x = u32[4]{0} parameter(0)
  c = u32[] constant(1)
  f1 = u32[4]{0} fusion(x), kind=kLoop, calls=fused_computation
  f2 = u32[4]{0} fusion(f1), kind=kLoop, calls=fused_computation
  t = (u32[4]{0}, u32[4]{0}) tuple(f1, f2)
  g = u32[4]{0} get-tuple-element(t), index=0
  cp = u32[4]{0} copy(g)
  s = u32[4]{0} all-to-all(cp), dimensions={0}
  ps = (u32[4]{0}, u32[4]{0}) collective-permute-start(s), source_target_pairs={{0,1}}
  ROOT pd = u32[4]{0} collective-permute-done(ps)
}
"""


def test_hlo_kernel_counts():
    assert smoke.hlo_kernel_counts(_HLO) == {"kernels": 6, "fusions": 2}


def test_collective_counts():
    assert smoke.collective_counts(_HLO) == {"all_to_all": 1,
                                             "collective_permute": 1}


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_refuses_without_gpu(args):
    r = _run([str(ROOT / "chip_smoke.py"), *args], ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone(tmp_path):
    """Copied alone into an empty directory, the script fails and prints no
    result: it runs the library and cannot stand in for it."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not any(line.startswith("{") and json.loads(line).get("ok")
                   for line in r.stdout.splitlines())
