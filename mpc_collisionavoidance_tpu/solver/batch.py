"""Lane-batched SQP-RTI solver — the production throughput path.

Functionally identical to `solver/sqp_rti.RTISolver` (one Gauss-Newton
linearization + one interior-point QP + full primal step per call, warm
start carried across calls), but the scenario batch lives on the minor-most
lane axis of every tensor (see ops/lanes.py for why), and the linearization
is done with a single `jax.linearize` whose linear map is re-applied to the
nx+nu basis tangents — one nonlinear trace, nx+nu cheap linear passes, all
elementwise over (N, L) lanes.  This replaces both the CasADi-generated
forward VDE *and* the outer per-instance `vmap` of the reference design.

Layouts:
    trajectories  xbar (nx, N+1, L), ubar (nu, N, L)
    measurements  x0 (nx, L), params (np, L), lh (nh, L)
Converters to/from batch-first (B, ...) layout are provided for interop
with the per-instance engine and host code.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpc_collisionavoidance_tpu.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu.ops.ipm_lanes import (
    LaneQP, ipm_solve_lanes)


#: f32 products on the lane path run at full precision: a GPU may otherwise
#: take TF32 for them, and the 3e-6 production tolerance sits only 10x
#: above the float32 duality-gap floor
_HIGHEST = jax.lax.Precision.HIGHEST


class LaneState(NamedTuple):
    xbar: jnp.ndarray  # (nx, N+1, L)
    ubar: jnp.ndarray  # (nu, N, L)


class LaneOutput(NamedTuple):
    u0: jnp.ndarray      # (nu, L)
    x1: jnp.ndarray      # (nx, L)
    gap: jnp.ndarray     # (L,)
    status: jnp.ndarray  # (L,)


def to_lanes(batch_first):
    """(B, d1, d2, ...) -> (d1, d2, ..., B)."""
    return jnp.moveaxis(jnp.asarray(batch_first), 0, -1)


def from_lanes(lane):
    """(d1, ..., B) -> (B, d1, ...)."""
    return jnp.moveaxis(lane, -1, 0)


class LaneRTISolver:
    def __init__(self, spec: OCPSpec, ipm_iters: int = 12,
                 ipm_tol: float = 1e-7, riccati: str = "lax",
                 condense: int = 1,
                 centering: str = "fixed", mu0=1.0,
                 extra_iters: int = 0, stall_tol: float = None):
        """`riccati`: "lax" (sequential `lax.scan` sweep), "pallas" (the
        Triton sweep kernel, kernels/riccati_pallas.py, NVIDIA GPUs; any
        lane count — lanes are padded internally to the kernel's lane
        group, so B=1 single-vehicle serving rides the same kernel as
        fleet batches), "auto" (the kernel up to its KERNEL_MAX_NX
        states, "lax" above), or "pscan" (associative-scan parallel Riccati,
        O(log N) depth — see ops/riccati_pscan).

        `condense`: partial-condensing group size M (HPIPM's knob, the
        reference's PARTIAL_CONDENSING_HPIPM role): groups of M shooting
        intervals are condensed before the IPM so the sequential Riccati
        chain shrinks from 2N to 2N/M steps (ops/condense_partial.py).
        1 = no condensing.  Must divide N.

        `centering`: "fixed" (constant sigma=0.1 barrier reduction),
        "adaptive" (per-lane Mehrotra-style sigma from the previous
        fraction-to-boundary step — no extra solve, ops/ipm_lanes.py), or
        "mehrotra" (the FULL predictor-corrector: an affine probe solve
        per iteration sets sigma=(mu_aff/mu)^3 and adds the second-order
        correction — 2 Riccati sweeps per iteration, but far fewer
        iterations on ill-conditioned weights like usv_position_control's
        1e5 position costs).  Adaptive reaches the float32 gap floor in
        fewer iterations than fixed at the flagship shape (docs/PERF.md).

        `extra_iters` / `stall_tol`: per-batch STALL ESCALATION — after
        the fixed `ipm_iters` scan, up to `extra_iters` more IPM
        iterations run in a `lax.while_loop` while any lane's duality
        gap exceeds `stall_tol` (default: the dtype-aware convergence
        tolerance).  This is how the production schedule stays at its
        base iterations on easy ticks yet survives the reference's
        1000-tick mission (scripts/usv_guidance_ca1/main.py:116) where
        obstacle rows activate and harden the QPs mid-mission
        (docs/PERF.md)."""
        from mpc_collisionavoidance_tpu.config import RICCATI_BACKENDS
        if riccati not in RICCATI_BACKENDS:
            raise ValueError(f"unknown riccati backend '{riccati}'")
        if condense < 1 or spec.N % condense != 0:
            raise ValueError(
                f"condense group size {condense} must divide N={spec.N}")
        if centering not in ("fixed", "adaptive", "mehrotra"):
            raise ValueError(f"unknown centering '{centering}'")
        self.spec = spec
        self.extra_iters = int(extra_iters)
        self.stall_tol = stall_tol
        self.ipm_iters = ipm_iters
        self.ipm_tol = ipm_tol
        self.riccati = riccati
        self.condense = condense
        self.centering = centering
        # initial barrier weight: 1.0 (historical) or "auto" (per-lane
        # gradient-scaled, ops/ipm_lanes.py)
        self.mu0 = mu0
        m = spec.model
        # static numpy cost blocks / slack weights, computed once from the
        # spec and broadcast lazily by the IPM
        Vx = np.asarray(spec.cost.Vx); Vu = np.asarray(spec.cost.Vu)
        W = np.asarray(spec.cost.W)
        Vx_e = np.asarray(spec.cost.Vx_e); W_e = np.asarray(spec.cost.W_e)
        scale = spec.stage_scale
        self._static = {
            "Qc": scale * (Vx.T @ W @ Vx), "QN": Vx_e.T @ W_e @ Vx_e,
            "Sc": scale * (Vu.T @ W @ Vx), "Rc": scale * (Vu.T @ W @ Vu),
        }
        # soft-row static weights: [ softened h rows | softened state-box
        # rows ] — same ordering as the per-instance engine
        # (ops/linearize.py:172-217); soft state-box rows leave the hard
        # box family and become selection-Jacobian soft rows (acados
        # idxsbx semantics, reference scripts/race_cars/
        # acados_settings_dev.py:81-85)
        zl_parts, Zl_parts, zu_parts, Zu_parts = [], [], [], []
        lsh_parts, ush_parts = [], []
        if spec.soft is not None:
            sp = spec.soft
            zl_parts.append(scale * np.asarray(sp.zl))
            Zl_parts.append(scale * np.asarray(sp.Zl))
            zu_parts.append(scale * np.asarray(sp.zu))
            Zu_parts.append(scale * np.asarray(sp.Zu))
            lsh_parts.append(np.asarray(sp.lsh))
            ush_parts.append(np.asarray(sp.ush))
        idxbx_all = np.asarray(m.idxbx, dtype=np.int64).reshape(-1)
        lbx_all = np.asarray(m.lbx, float).reshape(-1)
        ubx_all = np.asarray(m.ubx, float).reshape(-1)
        if spec.soft_bx is not None:
            sb = spec.soft_bx
            sbx_rows = np.asarray(sb.idxsbx, dtype=np.int64).reshape(-1)
            zl_parts.append(scale * np.asarray(sb.zl))
            Zl_parts.append(scale * np.asarray(sb.Zl))
            zu_parts.append(scale * np.asarray(sb.zu))
            Zu_parts.append(scale * np.asarray(sb.Zu))
            lsh_parts.append(np.asarray(sb.lsbx))
            ush_parts.append(np.asarray(sb.usbx))
        else:
            sbx_rows = np.zeros((0,), dtype=np.int64)
        if zl_parts:
            self._static.update(
                zl=np.concatenate(zl_parts), Zl=np.concatenate(Zl_parts),
                zu=np.concatenate(zu_parts), Zu=np.concatenate(Zu_parts),
                lsh=np.concatenate(lsh_parts), ush=np.concatenate(ush_parts))
        hard_bx = np.setdiff1d(np.arange(idxbx_all.size), sbx_rows)
        self.idxbu = tuple(int(i) for i in np.asarray(m.idxbu).reshape(-1))
        self.idxbx = tuple(int(i) for i in idxbx_all[hard_bx])
        self._lbx = lbx_all[hard_bx]
        self._ubx = ubx_all[hard_bx]
        self.sbx_state_idx = tuple(int(i) for i in idxbx_all[sbx_rows])
        self._lbx_s = lbx_all[sbx_rows]
        self._ubx_s = ubx_all[sbx_rows]
        if spec.soft is not None:
            self.soft_idx = tuple(int(i) for i in spec.soft.idxsh)
        else:
            self.soft_idx = ()
        self.hard_idx = tuple(int(i) for i in spec.hard_h_rows())

    # ------------------------------------------------------------------
    def init_state(self, x0_batch, dtype=jnp.float32) -> LaneState:
        """x0_batch: (B, nx) batch-first; returns lane-layout warm start
        (acados-style: all stages at x0, zero controls)."""
        x0 = to_lanes(jnp.asarray(x0_batch, dtype))       # (nx, L)
        N = self.spec.N
        xbar = jnp.broadcast_to(x0[:, None, :],
                                (x0.shape[0], N + 1, x0.shape[1]))
        ubar = jnp.zeros((self.spec.model.nu, N, x0.shape[1]), dtype)
        return LaneState(xbar=xbar, ubar=ubar)

    # ------------------------------------------------------------------
    def _build_qp(self, state: LaneState, x0, params, lh,
                  yref=None, yref_e=None) -> LaneQP:
        spec = self.spec
        m = spec.model
        nx, nu, N = m.nx, m.nu, spec.N
        xbar, ubar = state.xbar, state.ubar
        dtype = xbar.dtype
        L = xbar.shape[-1]
        scale = spec.stage_scale
        xs = xbar[:, :-1, :]                               # (nx, N, L)

        # ---- dynamics linearization: one trace, nx+nu linear passes ----
        # (the `linearize` scope names these ops in profiler traces)
        with jax.named_scope("linearize"):
            h_step = spec.dt / spec.integrator_steps

            def F(xu):
                x, u = xu[:nx], xu[nx:]
                for _ in range(spec.integrator_steps):
                    k1 = m.f(x, u, params)
                    k2 = m.f(x + 0.5 * h_step * k1, u, params)
                    k3 = m.f(x + 0.5 * h_step * k2, u, params)
                    k4 = m.f(x + h_step * k3, u, params)
                    x = x + (h_step / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
                return x

            xu = jnp.concatenate([xs, ubar], axis=0)       # (nxu, N, L)
            x_next, lin = jax.linearize(F, xu)
            # basis tangents in ONE vmapped pass (the linearized rollout
            # is traced once; the basis axis becomes a batch axis),
            # restricted to the coordinates f structurally reads: skipped
            # state columns are EXACT identity columns of the discrete
            # map, skipped control columns exact zeros (models declare
            # f_dep; verified vs jacfwd probing in tests/test_sparsity.py)
            nxu = nx + nu
            f_dep = m.f_dep
            if f_dep is None or len(f_dep) == nxu:
                basis = jnp.broadcast_to(
                    jnp.eye(nxu, dtype=dtype)[:, :, None, None],
                    (nxu,) + xu.shape)
                J = jax.vmap(lin)(basis)               # (nxu, nx, N, L)
            else:
                di = np.asarray(f_dep, dtype=np.int64)
                basis = jnp.broadcast_to(
                    jnp.eye(nxu, dtype=dtype)[di][:, :, None, None],
                    (len(f_dep),) + xu.shape)
                Jd = jax.vmap(lin)(basis)              # (nd, nx, N, L)
                J = jnp.broadcast_to(
                    jnp.eye(nxu, nx, dtype=dtype)[:, :, None, None],
                    (nxu, nx) + xu.shape[1:])
                J = J.at[di].set(Jd)
            J = jnp.transpose(J, (2, 1, 0, 3))             # (N, nx, nxu, L)
        A, Bm = J[:, :, :nx, :], J[:, :, nx:, :]
        c = jnp.moveaxis(x_next - xbar[:, 1:, :], 0, 1)    # (N, nx, L)

        # ---- cost (blocks precomputed once in __init__) ----
        Vx = np.asarray(spec.cost.Vx); Vu = np.asarray(spec.cost.Vu)
        W = np.asarray(spec.cost.W)
        Qc = jnp.asarray(self._static["Qc"], dtype)
        Rc = jnp.asarray(self._static["Rc"], dtype)
        Sc = jnp.asarray(self._static["Sc"], dtype)
        M_x = jnp.asarray(scale * (Vx.T @ W), dtype)       # (nx, ny)
        M_u = jnp.asarray(scale * (Vu.T @ W), dtype)       # (nu, ny)
        # runtime stage reference: (ny,) shared or (ny, L) per lane
        # (the reference pushes yref every tick, e.g. pf_ca main.py:113-133)
        if yref is None:
            yref = jnp.asarray(spec.cost.yref, dtype)[:, None, None]
        else:
            yref = jnp.asarray(yref, dtype)
            yref = (yref[:, None, None] if yref.ndim == 1
                    else yref[:, None, :])
        def tdot(a, b):
            # contract a's last axis with b's first, at full f32 precision
            return jnp.tensordot(a, b, axes=[[1], [0]], precision=_HIGHEST)

        y = (tdot(jnp.asarray(Vx, dtype), xs)
             + tdot(jnp.asarray(Vu, dtype), ubar)
             - yref)                                       # (ny, N, L)
        qx_path = jnp.moveaxis(tdot(M_x, y), 0, 1)         # (N, nx, L)
        qu = jnp.moveaxis(tdot(M_u, y), 0, 1)              # (N, nu, L)
        Vx_e = np.asarray(spec.cost.Vx_e); W_e = np.asarray(spec.cost.W_e)
        QN = jnp.asarray(self._static["QN"], dtype)
        if yref_e is None:
            yref_e_l = jnp.asarray(spec.cost.yref_e, dtype)[:, None]
        else:
            yref_e_l = jnp.asarray(yref_e, dtype)
            if yref_e_l.ndim == 1:
                yref_e_l = yref_e_l[:, None]
        yN = tdot(jnp.asarray(Vx_e, dtype), xbar[:, -1, :]) - yref_e_l
        qx_N = tdot(jnp.asarray(Vx_e.T @ W_e, dtype), yN)  # (nx, L)
        qx = jnp.concatenate([qx_path, qx_N[None]], axis=0)

        # ---- control box residuals ----
        if self.idxbu:
            usel = jnp.moveaxis(ubar[np.asarray(self.idxbu, dtype=np.int64)], 0, 1)  # (N, nbu, L)
            lbu = jnp.asarray(m.lbu, dtype)[None, :, None]
            ubu = jnp.asarray(m.ubu, dtype)[None, :, None]
            ub_lo = lbu - usel
            ub_hi = usel - ubu
        else:
            ub_lo = ub_hi = jnp.zeros((N, 0, L), dtype)

        # ---- state box residuals (stage 0 masked) ----
        xmask = (jnp.arange(N) > 0).astype(dtype)[:, None, None]
        if self.idxbx:
            xsel = jnp.moveaxis(xs[np.asarray(self.idxbx, dtype=np.int64)], 0, 1)    # (N, nbx, L)
            lbx = jnp.asarray(self._lbx, dtype)[None, :, None]
            ubx = jnp.asarray(self._ubx, dtype)[None, :, None]
            xb_lo = jnp.where(xmask > 0, lbx - xsel, -1.0)
            xb_hi = jnp.where(xmask > 0, xsel - ubx, -1.0)
        else:
            xb_lo = xb_hi = jnp.zeros((N, 0, L), dtype)

        # ---- nonlinear constraint linearization ----
        nh = m.nh
        if nh:
            def H(xv):
                return m.h(xv, params)

            hbar_l, linh = jax.linearize(H, xs)        # (nh, N, L)
            h_dep = m.h_dep
            if h_dep is None or len(h_dep) == nx:
                basis_x = jnp.broadcast_to(
                    jnp.eye(nx, dtype=dtype)[:, :, None, None],
                    (nx,) + xs.shape)
                C = jax.vmap(linh)(basis_x)            # (nx, nh, N, L)
            else:
                # h reads only h_dep coordinates (e.g. the flagship's
                # obstacle distances read only xned/yned): skipped
                # columns are exact zeros
                di = np.asarray(h_dep, dtype=np.int64)
                basis_x = jnp.broadcast_to(
                    jnp.eye(nx, dtype=dtype)[di][:, :, None, None],
                    (len(h_dep),) + xs.shape)
                Cd = jax.vmap(linh)(basis_x)           # (nd, nh, N, L)
                C = jnp.zeros((nx, nh) + xs.shape[1:],
                              dtype).at[di].set(Cd)
            C = jnp.transpose(C, (2, 1, 0, 3))         # (N, nh, nx, L)
            hbar = jnp.moveaxis(hbar_l, 0, 1)          # (N, nh, L)
            lh_full = (jnp.asarray(m.lh, dtype)[:, None] if lh is None
                       else jnp.asarray(lh, dtype))
            if lh_full.ndim == 1:
                lh_full = lh_full[:, None]
            uh_full = jnp.asarray(m.uh, dtype)[:, None]
        else:
            C = jnp.zeros((N, 0, nx, L), dtype)
            hbar = jnp.zeros((N, 0, L), dtype)
            lh_full = uh_full = jnp.zeros((0, 1), dtype)

        hi = np.asarray(self.hard_idx, dtype=np.int64)
        si = np.asarray(self.soft_idx, dtype=np.int64)
        Ch = C[:, hi]
        hh_lo = lh_full[hi][None] - hbar[:, hi]
        hh_hi = hbar[:, hi] - uh_full[hi][None]
        Cs = C[:, si]
        hofs = hbar[:, si]
        slh = jnp.broadcast_to(lh_full[si][None], (N, len(si), L))
        suh = jnp.broadcast_to(uh_full[si][None], (N, len(si), L))

        # ---- soft state-box rows appended to the soft family (constant
        # selection Jacobian, stage 0 masked with an O(1) inactive band,
        # mirroring ops/linearize.py:193-217) ----
        n_sbx = len(self.sbx_state_idx)
        if n_sbx:
            sidx = np.asarray(self.sbx_state_idx, dtype=np.int64)
            E_xs = np.zeros((n_sbx, nx))
            E_xs[np.arange(n_sbx), sidx] = 1.0
            Cs_bx = (jnp.broadcast_to(
                jnp.asarray(E_xs, dtype)[None, :, :, None],
                (N, n_sbx, nx, L)) * xmask[:, :, None, :])
            xsel_s = jnp.moveaxis(xs[sidx], 0, 1)          # (N, n_sbx, L)
            hofs_bx = xsel_s * xmask
            smask = (jnp.arange(N) > 0)[:, None, None]
            slh_bx = jnp.where(
                smask, jnp.asarray(self._lbx_s, dtype)[None, :, None], -1.0)
            suh_bx = jnp.where(
                smask, jnp.asarray(self._ubx_s, dtype)[None, :, None], 1.0)
            slh_bx = jnp.broadcast_to(slh_bx, (N, n_sbx, L))
            suh_bx = jnp.broadcast_to(suh_bx, (N, n_sbx, L))
            Cs = jnp.concatenate([Cs, Cs_bx], axis=1)
            hofs = jnp.concatenate([hofs, hofs_bx], axis=1)
            slh = jnp.concatenate([slh, slh_bx], axis=1)
            suh = jnp.concatenate([suh, suh_bx], axis=1)

        if "zl" in self._static:
            zl = jnp.asarray(self._static["zl"], dtype)[:, None]
            Zl = jnp.asarray(self._static["Zl"], dtype)[:, None]
            zu = jnp.asarray(self._static["zu"], dtype)[:, None]
            Zu = jnp.asarray(self._static["Zu"], dtype)[:, None]
            lsh = jnp.asarray(self._static["lsh"], dtype)[:, None]
            ush = jnp.asarray(self._static["ush"], dtype)[:, None]
        else:
            zl = Zl = zu = Zu = lsh = ush = jnp.zeros((0, 1), dtype)

        return LaneQP(
            A=A, B=Bm, c=c, dx0=x0 - xbar[:, 0, :],
            Qc=Qc, QN=QN, Sc=Sc, Rc=Rc, qx=qx, qu=qu,
            ub_lo=ub_lo, ub_hi=ub_hi,
            xb_lo=xb_lo, xb_hi=xb_hi, xmask=xmask,
            Ch=Ch, hh_lo=hh_lo, hh_hi=hh_hi,
            Cs=Cs, hofs=hofs, slh=slh, suh=suh,
            zl=zl, Zl=Zl, zu=zu, Zu=Zu, lsh=lsh, ush=ush,
        )

    # ------------------------------------------------------------------
    def _solve_qp(self, qp: LaneQP):
        if self.condense > 1:
            from mpc_collisionavoidance_tpu.ops.condense_partial import (
                condense_lane_qp, expand_solution)
            qp_c, idxbu_c, aux = condense_lane_qp(
                qp, self.condense, self.idxbu, self.idxbx)
            sol = ipm_solve_lanes(qp_c, idxbu_c, (),
                                  iters=self.ipm_iters, tol=self.ipm_tol,
                                  riccati=self.riccati,
                                  centering=self.centering, mu0=self.mu0,
                                  extra_iters=self.extra_iters,
                                  stall_tol=self.stall_tol)
            dx_f, du_f = expand_solution(aux, sol.dx, sol.du)
            return sol._replace(dx=dx_f, du=du_f)
        return ipm_solve_lanes(qp, self.idxbu, self.idxbx,
                               iters=self.ipm_iters, tol=self.ipm_tol,
                               riccati=self.riccati,
                               centering=self.centering, mu0=self.mu0,
                               extra_iters=self.extra_iters,
                               stall_tol=self.stall_tol)

    def _advance(self, state: LaneState, sol):
        xbar = state.xbar + jnp.moveaxis(sol.dx, 0, 1)     # (nx, N+1, L)
        ubar = state.ubar + jnp.moveaxis(sol.du, 0, 1)     # (nu, N, L)
        new_state = LaneState(xbar=xbar, ubar=ubar)
        out = LaneOutput(u0=ubar[:, 0, :], x1=xbar[:, 1, :],
                         gap=sol.gap, status=sol.status)
        return new_state, out

    def step_fn(self, state: LaneState, x0, params,
                lh: Optional[jnp.ndarray] = None,
                yref=None, yref_e=None):
        """One RTI tick for the whole lane batch.

        x0 (nx, L), params (np, L), lh (nh, L) or (nh,) or None;
        yref (ny,) or (ny, L), yref_e (nx,) or (nx, L) — None uses the
        builder's static references.
        """
        dtype = state.xbar.dtype
        x0 = jnp.asarray(x0, dtype)
        params = jnp.asarray(params, dtype)
        qp = self._build_qp(state, x0, params, lh, yref=yref,
                            yref_e=yref_e)
        sol = self._solve_qp(qp)
        return self._advance(state, sol)

    # ---- RTI preparation/feedback split (lane engine) ----
    # Same exact-split property as RTISolver.prepare_fn/feedback_fn
    # (solver/sqp_rti.py:120-163): the measurement enters the lane QP only
    # through dx0 = x0 - xbar[:, 0, :], so linearization + assembly can
    # run BEFORE the measurement arrives and the feedback phase pays only
    # the IPM.  prepare_fn(state) + feedback_fn(state, qp, x0) compose to
    # exactly step_fn(state, x0) for any x0.
    def prepare_fn(self, state: LaneState, params,
                   lh: Optional[jnp.ndarray] = None,
                   yref=None, yref_e=None) -> LaneQP:
        """Preparation phase: Gauss-Newton linearization + QP assembly at
        the warm-start iterate (dx0 placeholder 0)."""
        dtype = state.xbar.dtype
        params = jnp.asarray(params, dtype)
        return self._build_qp(state, state.xbar[:, 0, :], params, lh,
                              yref=yref, yref_e=yref_e)

    def feedback_fn(self, state: LaneState, qp: LaneQP, x0):
        """Feedback phase: re-pin the prepared QP at the fresh measurement
        and solve.  `qp` comes from `prepare_fn` on the SAME state."""
        dtype = state.xbar.dtype
        x0 = jnp.asarray(x0, dtype)
        qp = qp._replace(dx0=x0 - state.xbar[:, 0, :])
        sol = self._solve_qp(qp)
        return self._advance(state, sol)


class LaneSolverAdapter:
    """Instance-shaped facade over a :class:`LaneRTISolver` at lane
    width 1.

    Single-vehicle surfaces (`cli run`, the guidance controller,
    `sim/closed_loop.py`) were written against the per-instance
    `RTISolver` API — unbatched x0 (nx,), outputs u0 (nu,)/x1 (nx,).
    This adapter lets them ride the production lane engine (Riccati
    kernel, adaptive centering, stall escalation) unchanged: the kernel
    pads the single lane to one lane group internally.  Per-stage (N, ny) yref is not supported (the
    lane engine broadcasts one reference across stages); pass the 1-D
    (ny,) form.
    """

    def __init__(self, lane_solver: LaneRTISolver):
        self.lane = lane_solver
        self.spec = lane_solver.spec

    def init_state(self, x0, dtype=jnp.float32) -> LaneState:
        return self.lane.init_state(jnp.asarray(x0, dtype)[None, :],
                                    dtype=dtype)

    def step_fn(self, state: LaneState, x0, params, lh=None,
                yref=None, yref_e=None):
        dtype = state.xbar.dtype
        x0 = jnp.asarray(x0, dtype)[:, None]
        params = jnp.asarray(params, dtype)[:, None]
        if lh is not None:
            lh = jnp.asarray(lh, dtype)[:, None]
        st, o = self.lane.step_fn(state, x0, params, lh,
                                  yref=yref, yref_e=yref_e)
        return st, LaneOutput(u0=o.u0[:, 0], x1=o.x1[:, 0],
                              gap=o.gap[0], status=o.status[0])
