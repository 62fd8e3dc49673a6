"""SQP-RTI orchestration: the accelerator-native `acados_solve()`.

Reproduces the real-time-iteration semantics of the reference solver
(nlp_solver_type="SQP_RTI" + GAUSS_NEWTON + ERK, reference
scripts/usv_guidance_ca1/acados_settings.py:190-194): each call performs
exactly ONE Gauss-Newton linearization at the warm-started trajectory, one
QP solve, and one full-step primal update.  The warm start — acados keeps
its primal iterate in solver memory between ticks (SURVEY.md section 5,
checkpoint/resume) — becomes an explicit, device-resident, functionally
threaded `SolverState`, so it vmaps/shards along a scenario batch axis and
doubles as the checkpointable state for long sweeps.

Also provides `solve_converged`, a multi-iteration SQP loop (the reference's
commented-out nlp_solver_type="SQP" alternative) for oracle tests.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_collisionavoidance_tpu.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu.ops import linearize
from mpc_collisionavoidance_tpu.ops.dense_qp import dense_qp_solve
from mpc_collisionavoidance_tpu.ops.ipm import ipm_solve


class SolverState(NamedTuple):
    """Warm-start state carried across control ticks (per instance)."""

    xbar: jnp.ndarray  # (N+1, nx)
    ubar: jnp.ndarray  # (N, nu)


class SolverOutput(NamedTuple):
    u0: jnp.ndarray       # (nu,) stage-0 optimal input
    x1: jnp.ndarray       # (nx,) stage-1 predicted state (command source in
                          #       the reference, src/nmpc_guidance_ca1.cpp:586)
    xtraj: jnp.ndarray    # (N+1, nx) full predicted trajectory
    utraj: jnp.ndarray    # (N, nu)
    qp_gap: jnp.ndarray   # IPM complementarity at exit
    status: jnp.ndarray   # 0 ok / 1 qp not converged / 2 NaN


class RTISolver:
    """Factory for jitted RTI step functions specialized to one OCPSpec.

    Typical use::

        solver = RTISolver(spec)
        state = solver.init_state(x0)
        state, out = solver.step(state, x0, params, lh)       # one tick
        batch_step = jax.vmap(solver.step_fn)                  # batched
    """

    def __init__(self, spec: OCPSpec, ipm_iters: int = 18,
                 ipm_tol: float = 1e-7, qp_backend: str = "riccati",
                 centering: str = "fixed", mu0=1.0):
        """qp_backend selects the QP engine, mirroring the reference's
        qp_solver switch (PARTIAL_CONDENSING_HPIPM vs the commented
        FULL_CONDENSING_QPOASES, scripts/usv_guidance_ca1/
        acados_settings.py:189-190):

        - "riccati": stagewise IPM with a Riccati lax.scan per iteration
          (the HPIPM role) — O(N) per iteration, the production path.
        - "dense": full condensing + dense IPM (the qpOASES role) — one
          (N*nu)^2 Cholesky per iteration, an independent engine for
          cross-checks and short horizons.

        `centering`: "fixed" (constant sigma barrier schedule) or
        "mehrotra" (full predictor-corrector: affine probe + adaptive
        sigma + second-order correction, 2 Riccati sweeps/iteration —
        HPIPM's own schedule; converges ill-conditioned weights like
        usv_position_control's 1e5 position costs in the default
        iteration budget).  Riccati backend only.
        """
        if qp_backend not in ("riccati", "dense"):
            raise ValueError(f"unknown qp_backend {qp_backend!r}; "
                             "expected 'riccati' or 'dense'")
        if centering not in ("fixed", "mehrotra"):
            raise ValueError(f"unknown centering {centering!r}")
        if centering != "fixed" and qp_backend == "dense":
            raise ValueError("mehrotra centering is implemented on the "
                             "riccati backend only")
        self.spec = spec
        self.layout = linearize.make_row_layout(spec)
        self.ipm_iters = ipm_iters
        self.ipm_tol = ipm_tol
        self.qp_backend = qp_backend
        self.centering = centering
        # initial barrier weight: 1.0 (historical) or "auto"
        # (gradient-scaled, ops/ipm.py) for ill-conditioned weights
        self.mu0 = mu0

    # ---- state management ----
    def init_state(self, x0, dtype=jnp.float32) -> SolverState:
        """acados-style initialization: every stage state = x0, controls = 0
        (AcadosOcpSolver initializes its iterate from constraints.x0)."""
        x0 = jnp.asarray(x0, dtype)
        N = self.spec.N
        return SolverState(
            xbar=jnp.broadcast_to(x0, (N + 1,) + x0.shape),
            ubar=jnp.zeros((N, self.spec.model.nu), dtype),
        )

    def _qp_solve(self, qp):
        if self.qp_backend == "riccati":
            return ipm_solve(qp, iters=self.ipm_iters, tol=self.ipm_tol,
                             centering=self.centering, mu0=self.mu0)
        return dense_qp_solve(qp, iters=self.ipm_iters, tol=self.ipm_tol)

    # ---- single RTI step (pure function; jit/vmap-able) ----
    def step_fn(self, state: SolverState, x0, params, lh=None,
                yref=None, yref_e=None):
        spec, layout = self.spec, self.layout
        dtype = state.xbar.dtype
        N = spec.N
        ny = spec.cost.ny
        if yref is None:
            yref = jnp.broadcast_to(jnp.asarray(spec.cost.yref, dtype), (N, ny))
        if yref_e is None:
            yref_e = jnp.asarray(spec.cost.yref_e, dtype)
        x0 = jnp.asarray(x0, dtype)
        params = jnp.asarray(params, dtype)

        qp = linearize.build_qp(spec, layout, state.xbar, state.ubar,
                                x0, yref, yref_e, params, lh)
        sol = self._qp_solve(qp)

        # full RTI primal step (acados SQP_RTI takes the unit step)
        xbar = state.xbar + sol.dx
        ubar = state.ubar + sol.du
        new_state = SolverState(xbar=xbar, ubar=ubar)
        out = SolverOutput(u0=ubar[0], x1=xbar[1], xtraj=xbar, utraj=ubar,
                           qp_gap=sol.gap, status=sol.status)
        return new_state, out

    def step(self, state, x0, params, lh=None, yref=None, yref_e=None):
        """Jitted convenience wrapper around `step_fn`."""
        return self._jitted_step(state, x0, params, lh, yref, yref_e)

    # ---- RTI preparation/feedback split ----
    # acados SQP_RTI separates the tick into a PREPARATION phase
    # (linearize + assemble, done before the new measurement arrives) and
    # a FEEDBACK phase (solve the QP at the fresh x0) to minimize
    # measurement-to-command latency (SURVEY.md section 7, hard part 4).
    # The split is exact here: the measured state enters the QP only
    # through the initial-state pinning residual dx0 = x0 - xbar[0]
    # (reference lbx0=ubx0 semantics, src/nmpc_guidance_ca1.cpp:509-516),
    # so prepare_fn + feedback_fn compose to EXACTLY step_fn.
    def prepare_fn(self, state: SolverState, params, lh=None,
                   yref=None, yref_e=None):
        """Preparation phase: Gauss-Newton linearization at the warm-start
        iterate.  Independent of the (future) measurement; run it while
        waiting for the sensor tick."""
        spec, layout = self.spec, self.layout
        dtype = state.xbar.dtype
        N = spec.N
        ny = spec.cost.ny
        if yref is None:
            yref = jnp.broadcast_to(jnp.asarray(spec.cost.yref, dtype),
                                    (N, ny))
        if yref_e is None:
            yref_e = jnp.asarray(spec.cost.yref_e, dtype)
        params = jnp.asarray(params, dtype)
        # placeholder pinning at the predicted state (dx0 = 0); feedback
        # replaces it with the fresh measurement residual
        return linearize.build_qp(spec, layout, state.xbar, state.ubar,
                                  state.xbar[0], yref, yref_e, params, lh)

    def feedback_fn(self, state: SolverState, qp, x0):
        """Feedback phase: re-pin the prepared QP at the fresh measurement
        and solve.  `qp` comes from `prepare_fn` on the SAME state."""
        dtype = state.xbar.dtype
        x0 = jnp.asarray(x0, dtype)
        qp = qp._replace(dx0=x0 - state.xbar[0])
        sol = self._qp_solve(qp)
        xbar = state.xbar + sol.dx
        ubar = state.ubar + sol.du
        new_state = SolverState(xbar=xbar, ubar=ubar)
        out = SolverOutput(u0=ubar[0], x1=xbar[1], xtraj=xbar, utraj=ubar,
                           qp_gap=sol.gap, status=sol.status)
        return new_state, out

    @property
    def _jitted_step(self):
        if not hasattr(self, "_cached_jit"):
            self._cached_jit = jax.jit(self.step_fn)
        return self._cached_jit

    # ---- converged SQP (oracle / non-realtime mode) ----
    def solve_converged(self, state: SolverState, x0, params, lh=None,
                        yref=None, yref_e=None, sqp_iters: int = 30,
                        step_alpha: float = 1.0):
        """Run `sqp_iters` SQP iterations (re-linearize each time).

        `step_alpha`: primal step damping (globalization).  Full-step SQP
        (alpha = 1, the acados default) can enter a period-2 limit cycle
        on long-horizon nonconvex problems from a cold start (measured:
        flagship N=100 from 4 m cross-track error cycles at step norm
        0.49 forever; alpha = 0.5 converges the same problem to a 1e-16
        KKT fixed point).  Damping moves the iteration path, NOT the
        fixed point: x* satisfies dx = 0 for any alpha."""

        def body(st, _):
            st2, out = self.step_fn(st, x0, params, lh, yref, yref_e)
            if step_alpha != 1.0:
                st2 = SolverState(
                    xbar=st.xbar + step_alpha * (st2.xbar - st.xbar),
                    ubar=st.ubar + step_alpha * (st2.ubar - st.ubar))
                # keep the reported trajectory consistent with the damped
                # iterate actually carried (the undamped trial step's u0/x1
                # would disagree with `state` whenever not fully converged)
                out = out._replace(u0=st2.ubar[0], x1=st2.xbar[1],
                                   xtraj=st2.xbar, utraj=st2.ubar)
            return st2, out

        state, outs = jax.lax.scan(body, state, None, length=sqp_iters)
        last = jax.tree.map(lambda a: a[-1], outs)
        return state, last
