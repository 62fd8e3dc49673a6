"""Triton Riccati kernel vs the lax.scan lane implementation.

On the CPU the kernel runs in Pallas interpret mode (its own code, the
interpreter's arithmetic); the `gpu`-marked test compiles it for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (
    KERNEL_MAX_NX, LANE_BLOCK, lqr_solve_lanes_pallas)
from mpc_collisionavoidance_tpu.ops.riccati_lanes import (
    lqr_solve_lanes, random_lane_lqr)


def _assert_matches_lax(d, rtol=2e-4, atol=2e-5, **kw):
    dx_ref, du_ref = lqr_solve_lanes(d)
    dx, du = lqr_solve_lanes_pallas(d, **kw)
    assert dx.shape == dx_ref.shape and du.shape == du_ref.shape
    assert dx.dtype == dx_ref.dtype and du.dtype == du_ref.dtype
    np.testing.assert_allclose(np.asarray(dx), np.asarray(dx_ref),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(du), np.asarray(du_ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("nx,nu", [(8, 1), (8, 2), (4, 1), (14, 2)])
def test_pallas_matches_lax(nx, nu):
    """Flagship-like, nu=2, small and full-hull (nx=14, nu=2) widths."""
    d = random_lane_lqr(N=12, nx=nx, nu=nu, L=LANE_BLOCK)
    _assert_matches_lax(d, interpret=True)


@pytest.mark.parametrize("nx,nu", [(8, 1), (14, 2)])
def test_pallas_matches_lax_f64(nx, nu):
    """In float64 the kernel and the scan agree to rounding: the kernel
    carries only P's upper triangle where the scan symmetrizes, so the
    two differ in the last bits, not in the math."""
    d = random_lane_lqr(N=10, nx=nx, nu=nu, L=40, seed=5, dtype=jnp.float64)
    _assert_matches_lax(d, rtol=1e-10, atol=1e-12, interpret=True)


def test_pallas_multiblock_lanes():
    """Two lane groups -> grid of 2 programs; group boundaries must be
    invisible in the result."""
    d = random_lane_lqr(N=6, nx=5, nu=1, L=2 * LANE_BLOCK, seed=3)
    _assert_matches_lax(d, interpret=True)


@pytest.mark.parametrize("L,programs", [(1, 1), (130, 5), (512, 16)])
def test_pick_lane_block_and_padding(L, programs):
    """Lane groups are one warp (32 lanes) at every batch size; ragged L
    is edge-padded to whole groups and sliced back."""
    assert LANE_BLOCK == 32
    assert -(-L // LANE_BLOCK) == programs
    d = random_lane_lqr(N=4, nx=3, nu=1, L=L, seed=11)
    _assert_matches_lax(d, interpret=True)


@pytest.mark.parametrize("model,kernel", [("usv_guidance_ca1", True),
                                          ("usv_pf_ca", False)])
def test_auto_sweep_choice(monkeypatch, model, kernel):
    """riccati="auto" (the GPU preset) runs the kernel up to KERNEL_MAX_NX
    states (the flagship's 8) and the plain sweep above (the hull's 14);
    it never mixes the two."""
    from mpc_collisionavoidance_tpu.kernels import riccati_pallas
    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.ops import ipm_lanes
    from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver

    calls = []

    def spy(name, fn):
        def wrapped(d, **kw):
            calls.append(name)
            return fn(d, **kw)
        return wrapped

    monkeypatch.setattr(riccati_pallas, "lqr_solve_lanes_pallas",
                        spy("pallas", riccati_pallas.lqr_solve_lanes_pallas))
    monkeypatch.setattr(ipm_lanes, "lqr_solve_lanes",
                        spy("lax", ipm_lanes.lqr_solve_lanes))
    spec = builders.build(model, N=10)
    m = spec.model
    assert (m.nx <= KERNEL_MAX_NX) == kernel
    solver = LaneRTISolver(spec, ipm_iters=2, riccati="auto")
    x0 = np.zeros((3, m.nx), np.float32)
    lanes = lambda n: jnp.zeros((n, 3), jnp.float32)
    # tracing is enough: the sweep is chosen when the step is traced
    jax.eval_shape(solver.step_fn, solver.init_state(x0), lanes(m.nx),
                   lanes(m.np_), lanes(m.nh))
    assert calls and set(calls) == {"pallas" if kernel else "lax"}


def test_lane_engine_with_pallas_backend(interpret_riccati_kernel):
    """Full LaneRTISolver tick with the kernel backend (interpret) vs the
    lax backend: identical controls on the flagship OCP."""
    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.solver.batch import (
        LaneRTISolver, to_lanes)

    spec = builders.usv_guidance_ca1(Tf=2.0, N=10)
    sc = scenarios.guidance_ca1_default()
    B = LANE_BLOCK
    x0s = np.broadcast_to(sc.x0, (B, 8)).astype(np.float32)
    xL = to_lanes(jnp.asarray(x0s))
    pL = to_lanes(np.broadcast_to(sc.params, (B, 16)).astype(np.float32))
    lhL = to_lanes(np.broadcast_to(sc.lh, (B, 8)).astype(np.float32))

    outs = {}
    for backend in ("lax", "pallas"):
        solver = LaneRTISolver(spec, ipm_iters=6, riccati=backend)
        st = solver.init_state(x0s)
        st, out = jax.jit(solver.step_fn)(st, xL, pL, lhL)
        outs[backend] = np.asarray(out.u0)
    np.testing.assert_allclose(outs["pallas"], outs["lax"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("L", [1, 130])
def test_pallas_ragged_lanes(L):
    """Any lane count is accepted: the wrapper pads (edge mode) to a
    group multiple and slices back — the B=1 single-vehicle real-time
    path must ride the same kernel as fleet batches."""
    d = random_lane_lqr(N=6, nx=5, nu=1, L=L, seed=7)
    _assert_matches_lax(d, interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("nx,nu,L", [(8, 1, 1), (8, 1, 512)])
def test_pallas_compiled_matches_lax(gpu, nx, nu, L):
    """The kernel as compiled for the card, at the widths the preset runs
    it at, against the full-precision plain sweep."""
    d = jax.device_put(random_lane_lqr(N=100, nx=nx, nu=nu, L=L,
                                       dtype=jnp.float32), gpu)
    with jax.default_matmul_precision("highest"):
        _assert_matches_lax(d)
