"""Config layer, profiling, checkpointing, Frenet transforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_collisionavoidance_tpu.config import (
    FrameworkConfig, ParallelConfig, SolverConfig)
from mpc_collisionavoidance_tpu.utils import frenet
from mpc_collisionavoidance_tpu.utils.checkpointing import (
    restore_state, save_state)
from mpc_collisionavoidance_tpu.utils.profiling import SolveTimer


# ---------------------------------------------------------------------------
def test_config_roundtrip_and_build():
    cfg = FrameworkConfig(model="usv_guidance_ca1", N=20, Tf=1.0,
                          solver=SolverConfig(engine="lane", ipm_iters=6),
                          parallel=ParallelConfig(batch_per_device=256))
    d = cfg.to_dict()
    cfg2 = FrameworkConfig.from_dict(d)
    assert cfg2 == cfg
    spec = cfg2.build_spec()
    assert spec.N == 20 and spec.model.name == "usv_guidance_ca1"
    solver = cfg2.build_solver()
    from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver
    assert isinstance(solver, LaneRTISolver)


def test_config_validation():
    with pytest.raises(ValueError, match="unknown model"):
        FrameworkConfig(model="usv_nonexistent")
    with pytest.raises(ValueError, match="unknown engine"):
        SolverConfig(engine="gpu")
    with pytest.raises(ValueError, match="pallas riccati requires"):
        SolverConfig(engine="instance", riccati="pallas")


# ---------------------------------------------------------------------------
def test_solve_timer_summary():
    t = SolveTimer(batch=10)
    for _ in range(5):
        with t.tick():
            pass
    s = t.summary()
    assert s["ticks"] == 5 and s["batch"] == 10
    assert s["solves_per_s"] > 0
    assert s["max_ms"] >= s["avg_ms"] >= 0


# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver

    solver = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=10))
    st = solver.init_state(np.arange(8, dtype=np.float32))
    st = st._replace(ubar=st.ubar + 0.25)
    path = save_state(str(tmp_path / "ckpt"), st)
    restored = restore_state(path, st)
    assert type(restored).__name__ == "SolverState"
    np.testing.assert_array_equal(np.asarray(restored.xbar),
                                  np.asarray(st.xbar))
    np.testing.assert_array_equal(np.asarray(restored.ubar),
                                  np.asarray(st.ubar))


# ---------------------------------------------------------------------------
def test_frenet_roundtrip():
    x1, y1, ak = 2.0, -1.0, 0.7
    s, ye = 3.3, -0.8
    x, y = frenet.seg_to_xy(x1, y1, ak, s, ye)
    s2, ye2 = frenet.xy_to_seg(x1, y1, ak, x, y)
    np.testing.assert_allclose([float(s2), float(ye2)], [s, ye], atol=1e-12)


def test_polyline_project():
    wp = np.zeros((6, 2))
    wp[:4] = [[0, 0], [10, 0], [10, 10], [0, 10]]   # padded to 6
    # point near the middle of segment 1 (east leg), 0.5 m left
    k, s, ye = frenet.polyline_project(jnp.asarray(wp), 4, 5.0, 0.5)
    assert int(k) == 0
    np.testing.assert_allclose(float(s), 5.0, atol=1e-6)
    np.testing.assert_allclose(float(ye), 0.5, atol=1e-6)
    # point past the first corner, on the north leg
    k, s, ye = frenet.polyline_project(jnp.asarray(wp), 4, 10.4, 3.0)
    assert int(k) == 1
    np.testing.assert_allclose(float(s), 13.0, atol=1e-6)
    np.testing.assert_allclose(float(ye), -0.4, atol=1e-6)
    # padding rows must not capture the projection
    k, s, ye = frenet.polyline_project(jnp.asarray(wp), 4, -1.0, 11.0)
    assert int(k) == 2


def test_polyline_project_vmappable():
    wp = jnp.asarray(np.array([[0, 0], [10, 0], [10, 10]], np.float64))
    xs = jnp.linspace(0.0, 9.0, 7)
    ks, ss, yes = jax.vmap(lambda x: frenet.polyline_project(
        wp, 3, x, 1.0))(xs)
    assert ks.shape == (7,)
    np.testing.assert_allclose(np.asarray(ss), np.asarray(xs), atol=1e-6)


# ---------------------------------------------------------------------------
def test_distributed_single_process(monkeypatch):
    """Single-process path: init is a no-op, the global mesh covers all
    (virtual) devices, batch splitting validates divisibility."""
    from mpc_collisionavoidance_tpu.parallel import distributed

    assert distributed.init() == 0
    mesh = distributed.global_scenario_mesh()
    # conftest pins jax_default_device to cpu[0]; the mesh must follow the
    # pin (all 8 virtual cpu devices), not whatever platform sorts first
    assert mesh.devices.ravel()[0].platform == "cpu"
    assert mesh.devices.size == len(jax.devices("cpu"))
    assert distributed.per_process_batch(64) == 64
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    assert distributed.per_process_batch(64) == 16
    with pytest.raises(ValueError, match="not divisible"):
        distributed.per_process_batch(7)


def test_config_builder_only_variant():
    """race_cars_dev is a builder (no separate model): reachable via config
    with BOTH engines — the lane engine gained soft state-box support
    (spec.soft_bx, acados idxsbx semantics) so it no longer refuses."""
    from mpc_collisionavoidance_tpu.config import FrameworkConfig, SolverConfig

    cfg = FrameworkConfig(model="race_cars_dev", N=10, Tf=0.4,
                          solver=SolverConfig(engine="instance"))
    solver = cfg.build_solver()
    assert type(solver).__name__ == "RTISolver"
    assert cfg.build_spec().soft_bx is not None

    lane = FrameworkConfig(model="race_cars_dev", N=10, Tf=0.4).build_solver()
    assert type(lane).__name__ == "LaneRTISolver"
    assert lane.sbx_state_idx  # the soft box rows reached the lane engine


def test_config_mehrotra_and_auto_mu0():
    """Round-4 solver options reach both engines through the config."""
    import dataclasses

    from mpc_collisionavoidance_tpu.config import FrameworkConfig, SolverConfig

    c = FrameworkConfig(solver=SolverConfig(centering="mehrotra",
                                            mu0="auto", engine="instance"))
    s = c.build_solver()
    assert s.centering == "mehrotra" and s.mu0 == "auto"
    c = FrameworkConfig(solver=SolverConfig(centering="mehrotra",
                                            mu0="auto", engine="lane"))
    s = c.build_solver()
    assert s.centering == "mehrotra" and s.mu0 == "auto"
    with pytest.raises(ValueError, match="mu0"):
        FrameworkConfig(solver=SolverConfig(mu0="bogus"))
    # the whole-IPM kernel (fixed centering only) is gone
    with pytest.raises(ValueError, match="unknown riccati backend"):
        FrameworkConfig(solver=SolverConfig(centering="mehrotra",
                                            riccati="fused"))
