"""Device identity, the GPU requirement of measurement paths, the compile
cache helper, and `chip_smoke.py`'s contract pieces that run anywhere."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from mpc_collisionavoidance_tpu.utils import device

REPO = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        device.require_gpu(jax.devices("cpu"))


def test_device_fields_as_jax_reports_them():
    devs = jax.devices("cpu")
    assert device.device_fields(devs) == {
        "platform": "cpu", "kind": devs[0].device_kind, "count": len(devs)}


def test_bench_refuses_cpu():
    """bench.py times nothing without a GPU (no CPU fallback)."""
    with pytest.raises(RuntimeError, match="needs a GPU"):
        _load("bench").device_line()


def test_compile_cache_default_dir(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache lives at one fixed,
    git-ignored directory inside the checkout."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache()
        assert Path(path) == REPO / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no directory of
    its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    path = device.enable_compile_cache()
    assert path == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == prev


def test_chip_smoke_last_line():
    smoke = _load("chip_smoke")
    line = smoke.last_line({"platform": "gpu", "kind": "NVIDIA H100",
                            "count": 1, "extra": "ignored"})
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100",
                               "count": 1}}
    assert "\n" not in line


def test_chip_smoke_refuses_cpu():
    """On a host without a GPU the smoke exits non-zero and prints no
    verdict line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr
