"""One production preset, three consumers (round-4 VERDICT item 2).

config.production_engine() is the single source of truth for the shipped
solver engine; bench.py, the RT server CLI, and `cli run/mission` must all
resolve to it.  Round 4 shipped three surfaces with three different
defaults — these tests make that regression impossible to land silently.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

from mpc_collisionavoidance_tpu.config import SolverConfig, production_engine
from mpc_collisionavoidance_tpu.rt.server import resolve_engine_args

REPO = Path(__file__).resolve().parent.parent


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_preset_shape():
    for platform, kernel in (("cpu", "lax"), ("gpu", "auto")):
        p = production_engine(platform)
        assert p.engine == "lane"
        assert p.centering == "adaptive"
        assert p.ipm_iters == 4
        assert p.extra_iters >= 16        # mission-length insurance
        # ONE production tolerance: status gate == escalation target
        assert p.ipm_tol == p.stall_tol == 3e-6
        # warm QPs start the barrier where the gradient says, not at 1.0
        assert p.mu0 == "auto"
        assert p.riccati == kernel


@pytest.mark.parametrize("platform", ["rocm", "METAL", "interpreter"])
def test_preset_refuses_unknown_platform(platform):
    """No platform falls through to a default engine: only cpu and gpu
    have a preset."""
    with pytest.raises(ValueError, match="no production preset"):
        production_engine(platform)


def test_bench_and_server_resolve_to_preset(monkeypatch):
    """bench.py's engine defaults == the server CLI's resolved engine ==
    the preset, field by field, on both platforms."""
    for bad in ("BENCH_IPM_ITERS", "BENCH_CENTERING", "BENCH_RICCATI",
                "BENCH_EXTRA_ITERS", "BENCH_CONDENSE"):
        monkeypatch.delenv(bad, raising=False)
    bench = _bench_module()
    for platform in ("cpu", "gpu"):
        p = production_engine(platform)
        b = bench.engine_defaults(p)
        s = resolve_engine_args(platform=platform)
        assert s["engine"] == p.engine == "lane"
        for k in ("ipm_iters", "ipm_tol", "centering", "riccati",
                  "extra_iters", "stall_tol", "mu0"):
            assert b[k] == s[k] == getattr(p, k), (platform, k, b[k], s[k])


def test_server_explicit_flags_override():
    s = resolve_engine_args(engine="vmap", ipm_iters=12, platform="cpu")
    assert s["engine"] == "vmap" and s["ipm_iters"] == 12
    # vmap fallback: lane-only features resolve to safe values, so
    # `--engine vmap` alone starts without errors
    assert s["centering"] == "fixed" and s["extra_iters"] == 0
    s2 = resolve_engine_args(centering="mehrotra", mu0="auto",
                             platform="cpu")
    assert s2["centering"] == "mehrotra" and s2["mu0"] == "auto"


def test_cli_run_uses_production_preset():
    """`cli run` without --config reports the production engine/schedule
    in its JSON line (the third surface, integration-checked)."""
    out = subprocess.run(
        [sys.executable, "-m", "mpc_collisionavoidance_tpu", "run",
         "--model", "usv_guidance4", "-N", "10", "--tf", "0.1",
         "--steps", "20", "--platform", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-800:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    p = production_engine("cpu")
    assert metrics["engine"] == "lane"
    assert metrics["schedule"] == (
        f"adaptive@{p.ipm_iters}+esc{p.extra_iters}")
    assert metrics["finite"] is True


@pytest.mark.parametrize("riccati", ["fused", "fused_interpret",
                                     "pallas_interpret"])
def test_removed_riccati_options_rejected(riccati):
    """The whole-IPM kernel and interpret mode are no config values:
    nothing a user sets can reach Pallas interpret mode."""
    with pytest.raises(ValueError, match="unknown riccati backend"):
        SolverConfig(engine="lane", riccati=riccati)


def test_removed_linearize_option_rejected():
    """Linearization has one route (XLA); the option went with its
    kernel, on the config, the server and bench alike."""
    from mpc_collisionavoidance_tpu.rt.server import main as server_main

    with pytest.raises(TypeError, match="linearize"):
        SolverConfig(engine="lane", linearize="pallas")
    with pytest.raises(SystemExit):
        server_main(["--linearize", "pallas"])
    assert "linearize" not in _bench_module().engine_defaults(
        production_engine("cpu"))
