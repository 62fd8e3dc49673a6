"""Dense (full-condensing) QP engine tests — the qpOASES-role backend.

The reference exposes two QP engines behind one switch
(PARTIAL_CONDENSING_HPIPM vs the commented FULL_CONDENSING_QPOASES,
reference scripts/usv_guidance_ca1/acados_settings.py:189-190).  Here the
two QP engines are cross-checked against each other and against the
SLSQP dense oracle, and the condensing map itself is verified exactly.
"""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from mpc_collisionavoidance_tpu.ocp import builders
from mpc_collisionavoidance_tpu.ops.condense import condense, expand
from mpc_collisionavoidance_tpu.ops.dense_qp import dense_qp_solve
from mpc_collisionavoidance_tpu.ops.ipm import ipm_solve
from mpc_collisionavoidance_tpu.sim import scenarios
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver

from tests.test_ipm import make_qp, qp_to_dense, solve_dense


def test_condense_exactness():
    """dx = M w + m must satisfy the linear dynamics for any w, and the
    condensed objective must equal the stage objective."""
    rng = np.random.default_rng(10)
    qp = make_qp(rng, N=6, nx=3, nu=2)
    d = condense(qp)
    N, nx, nu = qp.B.shape

    w = jnp.asarray(rng.standard_normal(N * nu))
    dx, du = expand(d, w, N, nu)
    # dynamics residual is zero by construction
    res = (jnp.einsum("kab,kb->ka", qp.A, dx[:-1])
           + jnp.einsum("kab,kb->ka", qp.B, du) + qp.c - dx[1:])
    assert float(jnp.max(jnp.abs(res))) < 1e-12
    assert float(jnp.max(jnp.abs(dx[0] - qp.dx0))) < 1e-12

    # stage objective == condensed objective (up to constant offset): check
    # via two points so the constant cancels
    def stage_obj(dx, du):
        val = 0.5 * jnp.einsum("kx,kxy,ky->", dx, qp.Q, dx)
        val += jnp.einsum("kx,kx->", qp.qx, dx)
        val += jnp.einsum("ku,kux,kx->", du, qp.S, dx[:-1])
        val += 0.5 * jnp.einsum("ku,kuv,kv->", du, qp.R, du)
        val += jnp.einsum("ku,ku->", qp.qu, du)
        return val

    def cond_obj(w):
        return 0.5 * w @ d.H @ w + d.g @ w

    w2 = jnp.asarray(rng.standard_normal(N * nu))
    dx2, du2 = expand(d, w2, N, nu)
    diff_stage = float(stage_obj(dx, du) - stage_obj(dx2, du2))
    diff_cond = float(cond_obj(w) - cond_obj(w2))
    np.testing.assert_allclose(diff_cond, diff_stage, rtol=1e-9, atol=1e-9)

    # hard-row values agree
    g_stage = (jnp.einsum("krx,kx->kr", qp.Gx, dx[:-1])
               + jnp.einsum("kru,ku->kr", qp.Gu, du) - qp.gl).ravel()
    g_cond = d.Ghat @ w + d.dg
    np.testing.assert_allclose(np.asarray(g_cond), np.asarray(g_stage),
                               atol=1e-10)
    # soft-row values agree
    s_stage = (qp.hofs + jnp.einsum("krx,kx->kr", qp.Cx, dx[:-1])).ravel()
    s_cond = d.Chat @ w + d.dc
    np.testing.assert_allclose(np.asarray(s_cond), np.asarray(s_stage),
                               atol=1e-10)


def test_dense_matches_riccati_engine():
    """Both engines solve the same KKT system — solutions must agree."""
    rng = np.random.default_rng(11)
    qp = make_qp(rng)
    s_ric = ipm_solve(qp, iters=30)
    s_den = dense_qp_solve(qp, iters=30)
    assert int(s_ric.status) == 0
    assert int(s_den.status) == 0
    np.testing.assert_allclose(np.asarray(s_den.dx), np.asarray(s_ric.dx),
                               atol=5e-6)
    np.testing.assert_allclose(np.asarray(s_den.du), np.asarray(s_ric.du),
                               atol=5e-6)


def test_dense_matches_slsqp_with_active_constraints():
    rng = np.random.default_rng(12)
    qp = make_qp(rng, seed_scale=2.0)
    qp = qp._replace(gl=jnp.asarray(-0.05 - 0.05 * rng.random(qp.gl.shape)))
    sol = dense_qp_solve(qp, iters=30)
    assert int(sol.status) == 0
    # hard feasibility
    g = (np.einsum("kab,kb->ka", np.asarray(qp.Gx), np.asarray(sol.dx)[:-1])
         + np.einsum("kab,kb->ka", np.asarray(qp.Gu), np.asarray(sol.du))
         - np.asarray(qp.gl))
    assert g.min() > -1e-7

    nz, obj, cons, split = qp_to_dense(qp)
    res = solve_dense(qp, nz, obj, cons)
    dx_d, du_d, _, _ = split(res.x)
    np.testing.assert_allclose(np.asarray(sol.dx), dx_d, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sol.du), du_d, atol=1e-5)


@pytest.mark.slow
def test_dense_backend_closed_loop_equivalence():
    """RTISolver(qp_backend='dense') ticks must track the riccati backend on
    the flagship OCP (reduced horizon for test speed)."""
    spec = builders.usv_guidance_ca1(Tf=1.0, N=20)
    sc = scenarios.guidance_ca1_default()
    x0 = jnp.asarray(sc.x0)
    params, lh = jnp.asarray(sc.params), jnp.asarray(sc.lh)

    s_ric = RTISolver(spec, ipm_iters=25)
    s_den = RTISolver(spec, ipm_iters=25, qp_backend="dense")
    st_r = s_ric.init_state(sc.x0, dtype=jnp.float64)
    st_d = s_den.init_state(sc.x0, dtype=jnp.float64)

    for _ in range(5):
        st_r, out_r = s_ric.step_fn(st_r, x0, params, lh)
        st_d, out_d = s_den.step_fn(st_d, x0, params, lh)
        assert int(out_d.status) == 0
        np.testing.assert_allclose(np.asarray(out_d.utraj),
                                   np.asarray(out_r.utraj), atol=1e-5)
        np.testing.assert_allclose(np.asarray(out_d.xtraj),
                                   np.asarray(out_r.xtraj), atol=1e-5)
        # advance both loops with the riccati plant state so they stay
        # on the same trajectory
        x0 = out_r.x1


def test_dense_backend_vmap():
    """The dense engine must vmap over a batch like the stagewise one."""
    rng = np.random.default_rng(13)
    from mpc_collisionavoidance_tpu.ops.ipm import QPData
    qps = [make_qp(rng) for _ in range(3)]
    batched = QPData(*[jnp.stack([np.asarray(getattr(q, f)) for q in qps])
                       for f in QPData._fields])
    sols = jax.vmap(lambda qp: dense_qp_solve(qp, iters=30))(batched)
    for i, q in enumerate(qps):
        s = dense_qp_solve(q, iters=30)
        np.testing.assert_allclose(np.asarray(sols.dx[i]), np.asarray(s.dx),
                                   atol=1e-8)
