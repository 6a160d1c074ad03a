"""chip_smoke.py and the compile-cache helper, rehearsed on the CPU.

The phase functions run here at tiny sizes; the script itself and bench.py
must refuse to run without a GPU (no CPU fallback).
"""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ibx.utils import compile_cache  # noqa: E402

TINY_2D = dict(wall_h=4e-2, feature_h=2e-2)
TINY_3D = dict(wall_h=0.2, surface_h=0.3)


def _check_phase(res):
    assert res["ok"], res
    assert res["finite"]
    assert res["step_err"] <= res["tol"] == chip_smoke.STEP_TOL
    for k in ("build_s", "compile_s", "march_s"):
        assert res[k] > 0


def test_phase_2d_tiny():
    res = chip_smoke.phase_2d(steps=20, **TINY_2D)
    _check_phase(res)
    assert res["steps"] == 20 and res["cells"] > 0


def test_phase_3d_tiny():
    res = chip_smoke.phase_3d(steps=10, **TINY_3D)
    _check_phase(res)


def test_phase_multi_tiny():
    """The --multi phase on 4 of the 8 virtual CPU devices."""
    out = dict(chip_smoke.phase_multi(
        4, dev_steps=20, cmp_steps=2,
        kw2d=dict(chip_smoke.FLAGSHIP_2D, **TINY_2D),
        kw3d=dict(chip_smoke.SPHERE_3D, **TINY_3D)))
    assert set(out) == {"multi_collectives", "multi_2d", "multi_3d"}
    for res in out.values():
        assert res["ok"], res
        assert res["devices"] == 4
    for name in ("multi_2d", "multi_3d"):
        assert len(out[name]["sharded_step_s"]) == 2
        assert out[name]["step_err"] <= out[name]["tol"]


@pytest.mark.parametrize("n", [2, 8])
def test_collective_check(n):
    from ibx.parallel import make_device_mesh

    res = chip_smoke.collective_check(make_device_mesh(n))
    assert res == {"ok": True, "devices": n, "err": 0.0}


def test_watchdog_exits_a_hung_stage(tmp_path):
    """A stage that outlasts its watchdog dumps its stack and exits
    non-zero instead of hanging."""
    code = ("import time, chip_smoke\n"
            "with chip_smoke.watchdog(1, 'stuck stage'):\n"
            "    time.sleep(60)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "stuck stage" in proc.stderr
    assert "time.sleep" in proc.stderr or "line 3" in proc.stderr


def test_scaled_err_is_per_channel():
    ref = [[1.0, 100.0], [0.5, -200.0]]
    out = [[1.0, 102.0], [0.5, -200.0]]
    assert chip_smoke.scaled_err(out, ref) == pytest.approx(0.01)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert not proc.stdout.strip(), proc.stdout


def test_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, the script fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "No module named 'ibx'" in proc.stderr


@pytest.fixture
def cache_config():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_honours_env(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_falls_back_to_repo_path(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_contract_line():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    obj = json.loads(chip_smoke.contract_line([Dev()]))
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
