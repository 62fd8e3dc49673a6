"""Partial condensing (ops/condense_partial.py) vs the full-resolution
lane IPM: the condensed QP must reproduce the SAME optimum, since partial
condensing is an exact variable elimination (HPIPM's N2 knob, reference
scripts/usv_guidance_ca1/acados_settings.py:190 PARTIAL_CONDENSING_HPIPM).

Covers the three constraint regimes of the zoo:
- usv_guidance_ca1: soft h rows + u-box (the flagship),
- usv_pf_ca: HARD h rows + hard state boxes (-> condensed general rows
  with control coupling via the LaneQP.Dh blocks),
- race_cars_dev: soft state boxes (idxsbx semantics through condensing).

All f64 on CPU so the IPM converges to ~1e-13 duality gap and the
comparison is against the optimum, not solver noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_collisionavoidance_tpu.ocp import builders
from mpc_collisionavoidance_tpu.sim import scenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver, to_lanes

B = 8


def _inputs(name, spec):
    m = spec.model
    if name == "usv_guidance_ca1":
        sc = scenarios.guidance_ca1_default()
        x0 = np.broadcast_to(sc.x0, (B, m.nx)).copy()
        params = to_lanes(np.broadcast_to(sc.params, (B, m.np_)))
        lh = to_lanes(np.broadcast_to(sc.lh, (B, m.nh)))
    else:
        rng = np.random.default_rng(0)
        x0 = 0.1 * rng.standard_normal((B, m.nx))
        params = (to_lanes(np.full((B, m.np_), 100.0)) if m.np_
                  else jnp.zeros((0, B)))
        lh = (to_lanes(np.broadcast_to(np.asarray(m.lh), (B, m.nh)))
              if m.nh else None)
    return x0, params, lh


def _run(spec, M, x0, params, lh, ticks=3):
    sol = LaneRTISolver(spec, ipm_iters=25, condense=M)
    st = sol.init_state(x0, dtype=jnp.float64)
    xL = to_lanes(jnp.asarray(x0, jnp.float64))
    step = jax.jit(sol.step_fn)
    for _ in range(ticks):
        st, out = step(st, xL, params, lh)
    return np.asarray(out.u0), np.asarray(st.xbar), np.asarray(out.status)


# reference-scale dt (Tf/N = 0.01): the hull EOM is stiff enough that the
# RK4 diverges at dt ~ 1/12, which would test garbage, not condensing
@pytest.mark.parametrize("name,Ms", [
    ("usv_guidance_ca1", (2, 3, 4)),
    ("usv_pf_ca", (2, 4)),
    ("race_cars_dev", (2, 4)),
])
@pytest.mark.slow
def test_condensed_matches_full(name, Ms):
    spec = getattr(builders, name)(Tf=0.12, N=12)
    x0, params, lh = _inputs(name, spec)
    u0_ref, xbar_ref, status_ref = _run(spec, 1, x0, params, lh)
    assert np.all(status_ref == 0)
    for M in Ms:
        u0, xbar, status = _run(spec, M, x0, params, lh)
        assert np.all(status == 0), (name, M, status)
        np.testing.assert_allclose(u0, u0_ref, rtol=0, atol=1e-9,
                                   err_msg=f"{name} M={M}")
        np.testing.assert_allclose(xbar, xbar_ref, rtol=0, atol=1e-9,
                                   err_msg=f"{name} M={M}")


def test_condensed_closed_loop_flagship():
    """200-tick flagship closed loop (solver-as-plant) with M=4 vs M=1:
    trajectories must stay equal through the warm-start feedback."""
    spec = builders.usv_guidance_ca1()
    sc = scenarios.guidance_ca1_default()
    x0 = np.broadcast_to(sc.x0, (2, 8)).copy()
    params = to_lanes(np.broadcast_to(sc.params, (2, 16)))
    lh = to_lanes(np.broadcast_to(sc.lh, (2, 8)))

    trajs = {}
    for M in (1, 4):
        sol = LaneRTISolver(spec, ipm_iters=12, condense=M)
        st = sol.init_state(x0, dtype=jnp.float64)
        xL = to_lanes(jnp.asarray(x0, jnp.float64))

        def tick(carry, _):
            st, x = carry
            st, out = sol.step_fn(st, x, params, lh)
            return (st, out.x1), out.x1

        (_, _), xs = jax.lax.scan(tick, (st, xL), None, length=200)
        trajs[M] = np.asarray(xs)
    assert np.all(np.isfinite(trajs[4]))
    # 12 IPM iterations leave ~1e-9 optimality gaps whose difference
    # accumulates through 200 warm-start feedbacks; 2e-5 is still far
    # below the f32 cross-engine tolerance ball (docs/PERF.md)
    np.testing.assert_allclose(trajs[4], trajs[1], rtol=0, atol=2e-5)


def test_condense_validation():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    with pytest.raises(ValueError, match="divide"):
        LaneRTISolver(spec, condense=3)
    # the whole-IPM kernel that rejected condensing is gone
    with pytest.raises(ValueError, match="unknown riccati backend"):
        LaneRTISolver(spec, condense=2, riccati="fused")


def test_condensed_with_pallas_riccati_interpret(interpret_riccati_kernel):
    """The condensed macro QP (stage-varying cost, nu=M) must ride the
    Triton Riccati kernel unchanged (interpret mode on CPU)."""
    spec = builders.usv_guidance_ca1(Tf=0.5, N=8)
    sc = scenarios.guidance_ca1_default()
    from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (
        LANE_BLOCK)
    Bk = LANE_BLOCK
    x0 = np.broadcast_to(sc.x0, (Bk, 8)).copy()
    params = to_lanes(np.broadcast_to(sc.params, (Bk, 16)).astype(np.float32))
    lh = to_lanes(np.broadcast_to(sc.lh, (Bk, 8)).astype(np.float32))
    outs = {}
    for ric in ("lax", "pallas"):
        sol = LaneRTISolver(spec, ipm_iters=6, condense=4, riccati=ric)
        st = sol.init_state(x0)
        xL = to_lanes(jnp.asarray(x0, jnp.float32))
        st, out = jax.jit(sol.step_fn)(st, xL, params, lh)
        outs[ric] = np.asarray(out.u0)
    np.testing.assert_allclose(outs["pallas"], outs["lax"],
                               rtol=1e-4, atol=1e-5)
