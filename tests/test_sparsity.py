"""Structural input-dependency declarations vs jacfwd probing.

Every model in the zoo declares `f_dep` (the (x, u) coordinates its
dynamics read) and `h_dep` (the x coordinates its constraints read); the
linearization paths skip the other tangent passes, substituting EXACT
identity/zero Jacobian columns (ops/sparsity.py).  These tests pin:

1. every declaration equals the probed dependency set (a missing index
   would silently corrupt the Jacobian; an extra one only wastes work);
2. the sparse lane-engine QP is BITWISE identical to the dense one
   (skipped passes are exactly trivial, not approximately);
   at an iterate produced by either Riccati sweep.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mpc_collisionavoidance_tpu.models import variants
from mpc_collisionavoidance_tpu.ocp import builders
from mpc_collisionavoidance_tpu.ops.sparsity import (
    constraint_dependency, input_dependency)
from mpc_collisionavoidance_tpu.sim import scenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver, to_lanes


@pytest.mark.parametrize("name", sorted(builders.BUILDERS))
def test_declared_deps_match_probe(name):
    spec = builders.build(name)
    m = spec.model
    probed_f = input_dependency(m.f, m.nx, m.nu, m.np_)
    assert m.f_dep is not None, f"{name}: declare f_dep"
    assert tuple(m.f_dep) == probed_f, (
        f"{name}: declared f_dep {m.f_dep} != probed {probed_f}")
    if m.nh:
        probed_h = constraint_dependency(m.h, m.nx, m.np_)
        assert m.h_dep is not None, f"{name}: declare h_dep"
        assert tuple(m.h_dep) == probed_h, (
            f"{name}: declared h_dep {m.h_dep} != probed {probed_h}")


def test_curved_race_car_is_dense():
    """An injected curvature interpolant makes f read s and n — the
    straight-track sparsity must NOT be reused (it would silently drop
    the kappa(s) Jacobian terms)."""
    from mpc_collisionavoidance_tpu.utils.track import (
        make_kappa_fn, make_synthetic_track)

    track = make_synthetic_track()
    m = variants.race_cars(kappa_fn=make_kappa_fn(track))
    probed = input_dependency(m.f, m.nx, m.nu, m.np_)
    assert set(probed) <= set(m.f_dep), (probed, m.f_dep)
    assert 0 in m.f_dep and 1 in m.f_dep


def _qp_pair(riccati):
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    sc = scenarios.guidance_ca1_default()
    B = 4
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, 8)).copy()
    x0s[:, 2] += 0.3 * rng.standard_normal(B)
    xL = to_lanes(jnp.asarray(x0s, jnp.float64))
    pL = to_lanes(jnp.asarray(
        np.broadcast_to(sc.params, (B, 16)), jnp.float64))
    lhL = to_lanes(jnp.asarray(np.broadcast_to(sc.lh, (B, 8)), jnp.float64))

    qps = []
    for dense in (False, True):
        s = LaneRTISolver(spec, ipm_iters=5, riccati=riccati)
        if dense:
            m = spec.model
            s.spec = dataclasses.replace(
                spec, model=dataclasses.replace(m, f_dep=None, h_dep=None))
        st = s.init_state(x0s, dtype=jnp.float64)
        # a non-trivial iterate so Jacobians are state-dependent
        st, out = s.step_fn(st, xL, pL, lhL)
        qps.append(s._build_qp(st, out.x1, pL, lhL))
    return qps


@pytest.mark.parametrize("riccati", ["lax", "pscan"])
def test_sparse_qp_bitwise_equals_dense(riccati):
    """The QP built with declared sparsity equals the dense build bitwise,
    at an iterate produced by either Riccati sweep."""
    qp_sparse, qp_dense = _qp_pair(riccati)
    for field in ("A", "B", "c", "Ch", "Cs", "hofs", "qx", "qu"):
        a = np.asarray(getattr(qp_sparse, field))
        b = np.asarray(getattr(qp_dense, field))
        assert np.array_equal(a, b), f"{field} differs (not bitwise-exact)"


# ---------------------------------------------------------------------------
# Trajectory cross-check (round-4 ADVICE): the random-point probe can miss
# region-gated dependencies (jnp.where branches, saturations, clamped
# interpolants) whose gate never flips at the probe points.  Here the
# declared sparsity is checked against DENSE jacfwd Jacobians along a REAL
# closed-loop trajectory — any dependency active in the model's operating
# envelope shows up regardless of where its gate sits.

_TRAJ_SCENARIOS = {
    "usv_guidance_ca1": ("guidance_ca1_default", (3, 2)),
    "usv_pf_ca": ("pf_ca_default", (0, 6)),        # crosses u=1.25 drag gate
    "usv_pf": ("pf_default", (0, 6)),
    "usv_acados": ("acados_speed_default", (0, 0)),
    "usv_low_level": ("low_level_default", (0, 3)),
    "usv_position_control": ("position_control_default", (0, 1)),
    "usv_guidance": ("guidance_default", (2, 7)),
    "usv_guidance2": ("guidance2_default", (2, 8)),
    "usv_guidance3": ("guidance3_default", (2, 8)),
    "usv_guidance4": ("guidance4_default", (3, 2)),
    "usv_guidance5": ("guidance5_default", (3, 2)),
    "usv_guidance_ca": ("guidance_ca_default", (3, 2)),
}


def _trajectory_dep_check(name, ticks):
    import jax

    from mpc_collisionavoidance_tpu.sim.closed_loop import run_closed_loop
    from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver

    spec = builders.build(name)
    m = spec.model
    factory, err_idx = _TRAJ_SCENARIOS[name]
    sc = getattr(scenarios, factory)()
    params = (jnp.asarray(sc.params, jnp.float64) if np.size(sc.params)
              else jnp.zeros(m.np_))
    lh = jnp.asarray(sc.lh) if np.size(sc.lh) else None
    yref = None if sc.yref is None else jnp.tile(
        jnp.asarray(sc.yref, jnp.float64), (spec.N, 1))
    yref_e = None if sc.yref_e is None else jnp.asarray(
        sc.yref_e, jnp.float64)
    solver = RTISolver(spec, ipm_iters=12)
    res = run_closed_loop(solver, jnp.asarray(sc.x0), params, lh,
                          n_steps=ticks, err_idx=err_idx,
                          yref=yref, yref_e=yref_e)
    simX = np.asarray(res.simX)
    simU = np.asarray(res.simU)
    assert np.all(np.isfinite(simX)), name

    jac_f = jax.jacfwd(
        lambda xu, p: jnp.asarray(m.f(xu[:m.nx], xu[m.nx:], p)))
    dep_f = np.zeros(m.nx + m.nu, bool)
    if m.nh:
        jac_h = jax.jacfwd(lambda x, p: jnp.asarray(m.h(x, p)))
        dep_h = np.zeros(m.nx, bool)
    for k in range(0, ticks, max(ticks // 8, 1)):
        xu = jnp.concatenate([jnp.asarray(simX[k], jnp.float64),
                              jnp.asarray(simU[k], jnp.float64)])
        dep_f |= np.any(np.asarray(jac_f(xu, params)) != 0.0, axis=0)
        if m.nh:
            dep_h |= np.any(np.asarray(
                jac_h(jnp.asarray(simX[k], jnp.float64), params)) != 0.0,
                axis=0)
    missing_f = set(np.where(dep_f)[0]) - set(m.f_dep)
    assert not missing_f, (
        f"{name}: f reads {sorted(missing_f)} along its own closed-loop "
        f"trajectory but f_dep={m.f_dep} does not declare them — the "
        "sparse linearization would silently corrupt those Jacobian "
        "columns")
    if m.nh:
        missing_h = set(np.where(dep_h)[0]) - set(m.h_dep)
        assert not missing_h, (
            f"{name}: h reads {sorted(missing_h)} in its operating "
            f"envelope but h_dep={m.h_dep} does not declare them")


@pytest.mark.parametrize("name", ["usv_guidance_ca1", "usv_pf_ca"])
def test_trajectory_dependency_cross_check(name):
    """Fast tier: the flagship + the hull with the piecewise-drag gate."""
    _trajectory_dep_check(name, ticks=40)


@pytest.mark.slow
@pytest.mark.parametrize(
    "name", sorted(set(_TRAJ_SCENARIOS) - {"usv_guidance_ca1",
                                           "usv_pf_ca"}))
def test_trajectory_dependency_cross_check_zoo(name):
    _trajectory_dep_check(name, ticks=60)
