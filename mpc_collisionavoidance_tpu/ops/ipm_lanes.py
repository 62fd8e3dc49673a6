"""Lane-batched primal-dual interior point (`ops/ipm.py` in lane layout).

Same algorithm as :func:`mpc_collisionavoidance_tpu.ops.ipm.ipm_solve` —
path-following with slack/dual elimination, one Riccati sweep per iteration,
fraction-to-boundary, convergence freeze — but:

- the instance batch rides the minor-most lane axis L of every tensor, so
  all scalar row arithmetic is elementwise over the batch;
- constraint structure is exploited HPIPM-style instead of generic G rows:
  control/state boxes contribute DIAGONAL Hessian terms (no gram products),
  only the nonlinear h rows form rank-r grams;
- the LINEAR_LS cost Hessian blocks (Qc, QN, Sc, Rc) are stage/instance
  constant and broadcast lazily instead of being materialized;
- step size, duality gap, freeze mask and status are all per-lane (L,)
  vectors — each instance follows its own central path.
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mpc_collisionavoidance_tpu.ops import lanes as ln
from mpc_collisionavoidance_tpu.ops.riccati_lanes import LaneLQR, lqr_solve_lanes


#: f32 products run at full precision (a GPU may otherwise take TF32; the
#: production tolerance sits only 10x above the float32 gap floor)
_HIGHEST = jax.lax.Precision.HIGHEST


class LaneQP(NamedTuple):
    # dynamics
    A: jnp.ndarray       # (N, nx, nx, L)
    B: jnp.ndarray       # (N, nx, nu, L)
    c: jnp.ndarray       # (N, nx, L)
    dx0: jnp.ndarray     # (nx, L)
    # cost — either static blocks (2-D, already dt-scaled; broadcast
    # lazily) or stage/lane-varying (4-D (N, ., ., L); produced by
    # partial condensing, ops/condense_partial.py)
    Qc: jnp.ndarray      # (nx, nx) | (N, nx, nx, L)
    QN: jnp.ndarray      # (nx, nx)
    Sc: jnp.ndarray      # (nu, nx) | (N, nu, nx, L)
    Rc: jnp.ndarray      # (nu, nu) | (N, nu, nu, L)
    qx: jnp.ndarray      # (N+1, nx, L)
    qu: jnp.ndarray      # (N, nu, L)
    # control box rows (gl form): du_sel - ub_lo >= 0 ; -du_sel - ub_hi >= 0
    ub_lo: jnp.ndarray   # (N, nbu, L)
    ub_hi: jnp.ndarray   # (N, nbu, L)
    # state box rows, stage 0 masked via xmask
    xb_lo: jnp.ndarray   # (N, nbx, L)
    xb_hi: jnp.ndarray   # (N, nbx, L)
    xmask: jnp.ndarray   # (N, 1, 1) 0/1
    # hard h rows
    Ch: jnp.ndarray      # (N, nHh, nx, L)
    hh_lo: jnp.ndarray   # (N, nHh, L)   = lh_hard - hbar
    hh_hi: jnp.ndarray   # (N, nHh, L)   = hbar - uh_hard
    # soft rows
    Cs: jnp.ndarray      # (N, nS, nx, L)
    hofs: jnp.ndarray    # (N, nS, L)
    slh: jnp.ndarray     # (N, nS, L)
    suh: jnp.ndarray     # (N, nS, L)
    zl: jnp.ndarray      # (nS, 1)
    Zl: jnp.ndarray      # (nS, 1)
    zu: jnp.ndarray      # (nS, 1)
    Zu: jnp.ndarray      # (nS, 1)
    lsh: jnp.ndarray     # (nS, 1)
    ush: jnp.ndarray     # (nS, 1)
    # optional control coupling of the h/soft rows (partially condensed
    # QPs: a row is C dx + D du + offset); None = state-only rows
    Dh: jnp.ndarray = None   # (N, nHh, nu, L) | None
    Ds: jnp.ndarray = None   # (N, nS, nu, L) | None


class LaneIPMSolution(NamedTuple):
    dx: jnp.ndarray      # (N+1, nx, L)
    du: jnp.ndarray      # (N, nu, L)
    gap: jnp.ndarray     # (L,)
    eq_res: jnp.ndarray  # (L,)
    status: jnp.ndarray  # (L,) int32


def _min_ratio(z, Dz):
    """Per-lane fraction-to-boundary ratio over all leading axes."""
    r = jnp.where(Dz < 0, -z / jnp.where(Dz < 0, Dz, -1.0), jnp.inf)
    return jnp.min(r, axis=tuple(range(r.ndim - 1)))


def ipm_solve_lanes(qp: LaneQP,
                    idxbu: Tuple[int, ...],
                    idxbx: Tuple[int, ...],
                    iters: int = 12,
                    tau: float = 0.995,
                    sigma: float = 0.1,
                    tol: float = 1e-7,
                    mu0: float = 1.0,
                    riccati: str = "lax",
                    centering: str = "fixed",
                    extra_iters: int = 0,
                    stall_tol: float = None,
                    return_gap_trace: bool = False) -> LaneIPMSolution:
    """`centering="adaptive"` replaces the fixed sigma with a per-lane
    Mehrotra-style heuristic driven by the previous iteration's
    fraction-to-boundary step: sigma_k = clip((1 - alpha_{k-1})^3,
    sigma_min, 0.5).  Long steps (alpha near 1) mean the affine direction
    is good, so the barrier is cut aggressively; short steps re-center.
    This is the no-extra-solve half of Mehrotra's predictor-corrector
    (the affine probe solve is skipped; alpha_{k-1} is its proxy), the
    same adaptivity HPIPM gets from its predictor step.

    `extra_iters` > 0 enables STALL ESCALATION: after the fixed `iters`
    scan, a bounded `lax.while_loop` keeps iterating — up to
    `extra_iters` more times — while ANY lane's duality gap is still
    above `stall_tol` (default: the dtype-aware status tolerance).  Easy
    QPs (every lane converged, e.g. the first ~100 ticks of the flagship
    mission) pay ZERO extra Riccati sweeps; mid-mission hardened QPs
    (obstacle rows active, where adaptive@8 alone leaves ~41% of
    mission-length solves above the 1e-5 health gate — VERDICT r4) buy
    exactly the iterations they need.  Escalation iterations are not
    recorded in `return_gap_trace` (the trace covers the fixed scan)."""
    N, nx, nu, L = qp.B.shape[0], qp.A.shape[1], qp.B.shape[2], qp.B.shape[-1]
    nbu, nbx = len(idxbu), len(idxbx)
    nHh = qp.Ch.shape[1]
    nS = qp.Cs.shape[1]
    dtype = qp.A.dtype
    n_total = max(N * (2 * nbu + 2 * nbx + 2 * nHh + 4 * nS), 1)
    gap_floor = jnp.asarray(1e-13 if dtype == jnp.float64 else 3e-7, dtype)

    idxbu = tuple(int(i) for i in idxbu)
    idxbx = tuple(int(i) for i in idxbx)

    if riccati == "auto":
        from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (
            KERNEL_MAX_NX)
        riccati = "pallas" if nx <= KERNEL_MAX_NX else "lax"
    if riccati == "pallas":
        from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (
            lqr_solve_lanes_pallas as riccati_fn)
    elif riccati == "pscan":
        from mpc_collisionavoidance_tpu.ops.riccati_pscan import (
            lqr_solve_pscan as riccati_fn)
    elif riccati == "lax":
        riccati_fn = lqr_solve_lanes
    else:
        raise ValueError(f"unknown riccati backend '{riccati}'")

    def du_sel(du):
        return du[:, np.asarray(idxbu, dtype=np.int64), :] if nbu else du[:, :0, :]

    def dx_sel(dx_path):
        return dx_path[:, np.asarray(idxbx, dtype=np.int64), :] if nbx else dx_path[:, :0, :]

    # control coupling of h/soft rows (partially condensed QPs)
    has_Dh = qp.Dh is not None and nHh > 0
    has_Ds = qp.Ds is not None and nS > 0

    def h_val(dxp, du):
        hv = ln.srows_mv(qp.Ch, dxp)
        return hv + ln.srows_mv(qp.Dh, du) if has_Dh else hv

    def s_val(dxp, du):
        gv = ln.srows_mv(qp.Cs, dxp)
        return gv + ln.srows_mv(qp.Ds, du) if has_Ds else gv

    def g_families(dx, du):
        dxp = dx[:-1]
        g_ulo = du_sel(du) - qp.ub_lo
        g_uhi = -du_sel(du) - qp.ub_hi
        g_xlo = qp.xmask * dx_sel(dxp) - qp.xb_lo
        g_xhi = -qp.xmask * dx_sel(dxp) - qp.xb_hi
        hv = h_val(dxp, du) if nHh else jnp.zeros((N, 0, L), dtype)
        g_hlo = hv - qp.hh_lo
        g_hhi = -hv - qp.hh_hi
        gv = (qp.hofs + s_val(dxp, du)) if nS \
            else jnp.zeros((N, 0, L), dtype)
        return g_ulo, g_uhi, g_xlo, g_xhi, g_hlo, g_hhi, gv

    # ---------------- initialization ----------------
    dx = jnp.zeros((N + 1, nx, L), dtype)
    du = jnp.zeros((N, nu, L), dtype)
    g0 = g_families(dx, du)
    gv0 = g0[6]
    s_margin = jnp.asarray(0.1, dtype)
    sl = jnp.maximum(qp.slh - gv0, qp.lsh) + s_margin
    su = jnp.maximum(gv0 - qp.suh, qp.ush) + s_margin
    t_min = jnp.asarray(0.1, dtype)
    ts = []
    for g in g0[:6]:
        ts.append(jnp.maximum(g, t_min))
    t_ulo, t_uhi, t_xlo, t_xhi, t_hlo, t_hhi = ts
    t_sl = jnp.maximum(gv0 - qp.slh + sl, t_min)
    t_su = jnp.maximum(qp.suh - gv0 + su, t_min)
    t_bsl = jnp.maximum(sl - qp.lsh, t_min)
    t_bsu = jnp.maximum(su - qp.ush, t_min)
    all_t = (t_ulo, t_uhi, t_xlo, t_xhi, t_hlo, t_hhi,
             t_sl, t_su, t_bsl, t_bsu)
    if isinstance(mu0, str):
        # "auto": per-lane gradient-proportional initial barrier weight
        # (see ops/ipm.py::ipm_solve docstring — removes the dual-growth
        # plateau on 1e5-scale cost weights like usv_position_control)
        if mu0 != "auto":
            raise ValueError(f"unknown mu0 '{mu0}'")
        g_scale = jnp.maximum(jnp.max(jnp.abs(qp.qx), axis=(0, 1)),
                              jnp.max(jnp.abs(qp.qu), axis=(0, 1)))
        # lower clip 1e-3 (was 1.0): a warm-started RTI QP has a SMALL
        # cost gradient, and restarting its barrier at 1.0 burns ~2
        # iterations just walking mu back down — the production
        # schedule's single biggest cost (docs/PERF.md).  Large-weight
        # cold QPs (usv_position_control's 1e5 costs) still get
        # mu0 ~ 1e3: the clip only floors.
        mu0 = jnp.clip(0.01 * g_scale, 1e-3, 1e6)[None, None, :]
    all_l = tuple(mu0 / t for t in all_t)

    def body(carry, _):
        (dx, du, sl, su), t, lam, sigma_l = carry
        (t_ulo, t_uhi, t_xlo, t_xhi, t_hlo, t_hhi,
         t_sl, t_su, t_bsl, t_bsu) = t
        (l_ulo, l_uhi, l_xlo, l_xhi, l_hlo, l_hhi,
         l_sl, l_su, l_bsl, l_bsu) = lam

        g_ulo, g_uhi, g_xlo, g_xhi, g_hlo, g_hhi, gv = g_families(dx, du)
        r_ulo, r_uhi = g_ulo - t_ulo, g_uhi - t_uhi
        r_xlo, r_xhi = g_xlo - t_xlo, g_xhi - t_xhi
        r_hlo, r_hhi = g_hlo - t_hlo, g_hhi - t_hhi
        r_sl = (gv - qp.slh + sl) - t_sl
        r_su = (qp.suh - gv + su) - t_su
        r_bsl = (sl - qp.lsh) - t_bsl
        r_bsu = (su - qp.ush) - t_bsu

        def lanes_sum(x):
            return jnp.sum(x, axis=tuple(range(x.ndim - 1)))

        gap = sum(lanes_sum(li * ti) for li, ti in zip(lam, t)) / n_total
        mu = sigma_l * gap                                   # (L,)
        muv = mu[None, None, :]

        a_ulo, a_uhi = l_ulo / t_ulo, l_uhi / t_uhi
        a_xlo, a_xhi = l_xlo / t_xlo, l_xhi / t_xhi
        a_hlo, a_hhi = l_hlo / t_hlo, l_hhi / t_hhi
        a_sl, a_su = l_sl / t_sl, l_su / t_su
        a_bsl, a_bsu = l_bsl / t_bsl, l_bsu / t_bsu

        # mu-independent soft elimination scalars
        beta_l = qp.Zl + a_sl + a_bsl
        beta_u = qp.Zu + a_su + a_bsu
        abar_l = a_sl * (qp.Zl + a_bsl) / beta_l
        abar_u = a_su * (qp.Zu + a_bsu) / beta_u

        # ---- modified Hessians ----
        Qbar = (qp.Qc if qp.Qc.ndim == 4
                else jnp.broadcast_to(qp.Qc[None, :, :, None], (N, nx, nx, L)))
        if nbx:
            diag = jnp.zeros((N, nx, L), dtype)
            diag = diag.at[:, np.asarray(idxbx, dtype=np.int64), :].add(qp.xmask * (a_xlo + a_xhi))
            Qbar = Qbar + diag[:, :, None, :] * jnp.eye(nx, dtype=dtype)[None, :, :, None]
        if nHh:
            Qbar = Qbar + ln.sgram_rows(qp.Ch, a_hlo + a_hhi)
        if nS:
            Qbar = Qbar + ln.sgram_rows(qp.Cs, abar_l + abar_u)
        Q_all = jnp.concatenate(
            [Qbar, jnp.broadcast_to(qp.QN[None, :, :, None], (1, nx, nx, L))],
            axis=0)

        Rbar = (qp.Rc if qp.Rc.ndim == 4
                else jnp.broadcast_to(qp.Rc[None, :, :, None], (N, nu, nu, L)))
        if nbu:
            diag_u = jnp.zeros((N, nu, L), dtype)
            diag_u = diag_u.at[:, np.asarray(idxbu, dtype=np.int64), :].add(a_ulo + a_uhi)
            Rbar = Rbar + diag_u[:, :, None, :] * jnp.eye(nu, dtype=dtype)[None, :, :, None]
        Sbar = (qp.Sc if qp.Sc.ndim == 4
                else jnp.broadcast_to(qp.Sc[None, :, :, None], (N, nu, nx, L)))
        if has_Dh:
            w_h = a_hlo + a_hhi
            Rbar = Rbar + ln.sgram_rows(qp.Dh, w_h)
            Sbar = Sbar + ln.sgram_cross(qp.Dh, qp.Ch, w_h)
        if has_Ds:
            w_s = abar_l + abar_u
            Rbar = Rbar + ln.sgram_rows(qp.Ds, w_s)
            Sbar = Sbar + ln.sgram_cross(qp.Ds, qp.Cs, w_s)

        # ---- mu-independent gradient bases + dynamics residuals ----
        dxp, dxN = dx[:-1], dx[-1]
        if qp.Qc.ndim == 4:
            qx_base = qp.qx[:-1] + ln.smv(qp.Qc, dxp) + ln.smtv(qp.Sc, du)
        else:
            qx_base = (qp.qx[:-1]
                       + jnp.einsum("ij,kjl->kil", qp.Qc, dxp,
                                    precision=_HIGHEST)
                       + jnp.einsum("ui,kul->kil", qp.Sc, du,
                                    precision=_HIGHEST))
        qx_N = qp.qx[-1] + jnp.einsum("ij,jl->il", qp.QN, dxN,
                                    precision=_HIGHEST)
        if qp.Rc.ndim == 4:
            qu_base = qp.qu + ln.smv(qp.Sc, dxp) + ln.smv(qp.Rc, du)
        else:
            qu_base = (qp.qu
                       + jnp.einsum("ui,kil->kul", qp.Sc, dxp,
                                    precision=_HIGHEST)
                       + jnp.einsum("uv,kvl->kul", qp.Rc, du,
                                    precision=_HIGHEST))
        cbar = ln.smv(qp.A, dxp) + ln.smv(qp.B, du) + qp.c - dx[1:]
        ddx0 = qp.dx0 - dx[0]

        def newton(mvec):
            """One Newton direction for per-family complementarity targets
            `mvec` (10-tuple, each broadcastable to its t family):
            T dlam + Lam dt = m - Lam T e.  m = sigma*mu*e reproduces the
            plain centering step; m = 0 is Mehrotra's affine probe;
            m = sigma*mu - Dt_aff*Dlam_aff the corrector."""
            (m_ulo, m_uhi, m_xlo, m_xhi, m_hlo, m_hhi,
             m_sl, m_su, m_bsl, m_bsu) = mvec
            k_l = m_sl / t_sl + m_bsl / t_bsl - qp.zl - qp.Zl * sl \
                - a_sl * r_sl - a_bsl * r_bsl
            k_u = m_su / t_su + m_bsu / t_bsu - qp.zu - qp.Zu * su \
                - a_su * r_su - a_bsu * r_bsu
            qtil_l = m_sl / t_sl - a_sl * r_sl - a_sl * k_l / beta_l
            qtil_u = m_su / t_su - a_su * r_su - a_su * k_u / beta_u

            qx_path = qx_base
            if nbx:
                vec = qp.xmask * ((m_xlo / t_xlo - a_xlo * r_xlo)
                                  - (m_xhi / t_xhi - a_xhi * r_xhi))
                qx_path = qx_path.at[:, np.asarray(idxbx, dtype=np.int64), :].add(-vec)
            v_hlo = m_hlo / t_hlo - a_hlo * r_hlo
            v_hhi = m_hhi / t_hhi - a_hhi * r_hhi
            if nHh:
                qx_path = qx_path - ln.srows_tv(qp.Ch, v_hlo)
                qx_path = qx_path + ln.srows_tv(qp.Ch, v_hhi)
            if nS:
                qx_path = qx_path - ln.srows_tv(qp.Cs, qtil_l) \
                    + ln.srows_tv(qp.Cs, qtil_u)
            qx_all = jnp.concatenate([qx_path, qx_N[None]], axis=0)

            qu_bar = qu_base
            if nbu:
                vec_u = (m_ulo / t_ulo - a_ulo * r_ulo) \
                    - (m_uhi / t_uhi - a_uhi * r_uhi)
                qu_bar = qu_bar.at[:, np.asarray(idxbu, dtype=np.int64), :].add(-vec_u)
            if has_Dh:
                qu_bar = qu_bar - ln.srows_tv(qp.Dh, v_hlo) \
                    + ln.srows_tv(qp.Dh, v_hhi)
            if has_Ds:
                qu_bar = qu_bar - ln.srows_tv(qp.Ds, qtil_l) \
                    + ln.srows_tv(qp.Ds, qtil_u)

            # ---- Newton step via lane Riccati ----
            Ddx, Ddu = riccati_fn(LaneLQR(qp.A, qp.B, cbar, Q_all, Sbar,
                                          Rbar, qx_all, qu_bar, ddx0))
            Ddxp = Ddx[:-1]

            # ---- recover slack/dual steps ----
            Dgv = s_val(Ddxp, Ddu) if nS else gv
            Dsl = (k_l - a_sl * Dgv) / beta_l if nS else sl
            Dsu = (k_u + a_su * Dgv) / beta_u if nS else su
            Dhv = h_val(Ddxp, Ddu) if nHh else r_hlo * 0
            Dt = (
                du_sel(Ddu) + r_ulo,
                -du_sel(Ddu) + r_uhi,
                qp.xmask * dx_sel(Ddxp) + r_xlo,
                -qp.xmask * dx_sel(Ddxp) + r_xhi,
                Dhv + r_hlo,
                -Dhv + r_hhi,
                Dgv + Dsl + r_sl,
                -Dgv + Dsu + r_su,
                Dsl + r_bsl,
                Dsu + r_bsu,
            )
            Dlam = tuple((mv - li * ti) / ti - (li / ti) * Dti
                         for mv, li, ti, Dti in zip(mvec, lam, t, Dt))
            return Ddx, Ddu, Dsl, Dsu, Dt, Dlam

        if centering == "mehrotra":
            # ---- affine probe (sigma = 0): one extra Riccati sweep ----
            zerov = jnp.zeros_like(muv)
            Ddx_a, Ddu_a, _, _, Dt_a, Dl_a = newton((zerov,) * 10)
            alpha_a = jnp.ones((L,), dtype)
            for z, Dz in zip(t, Dt_a):
                if 0 in z.shape:
                    continue
                alpha_a = jnp.minimum(alpha_a, _min_ratio(z, Dz))
            for z, Dz in zip(lam, Dl_a):
                if 0 in z.shape:
                    continue
                alpha_a = jnp.minimum(alpha_a, _min_ratio(z, Dz))
            av_a = alpha_a[None, None, :]
            mu_aff = sum(
                lanes_sum((li + av_a * Dli) * (ti + av_a * Dti))
                for li, ti, Dli, Dti in zip(lam, t, Dl_a, Dt_a)) / n_total
            mu_aff = jnp.maximum(mu_aff, 0.0)
            aff_ok = (jnp.isfinite(mu_aff) & jnp.isfinite(alpha_a)
                      & jnp.all(jnp.isfinite(Ddx_a), axis=(0, 1))
                      & jnp.all(jnp.isfinite(Ddu_a), axis=(0, 1)))
            ratio = mu_aff / jnp.maximum(gap, gap_floor)
            sig = jnp.clip(ratio * ratio * ratio, 1e-4, 0.99)
            sig = jnp.where(aff_ok, sig, 0.5)        # plain centering fallback
            tgt = (sig * gap)[None, None, :]
            okv = aff_ok[None, None, :]
            # corrector: sigma*mu*e minus the second-order term Dt_aff*Dl_aff
            mvec = tuple(
                jnp.where(okv, tgt - Dti * Dli, 0.5 * gap[None, None, :])
                for Dti, Dli in zip(Dt_a, Dl_a))
            Ddx, Ddu, Dsl, Dsu, Dt, Dlam = newton(mvec)
        else:
            Ddx, Ddu, Dsl, Dsu, Dt, Dlam = newton((muv,) * 10)

        # ---- per-lane fraction-to-boundary ----
        alpha = jnp.ones((L,), dtype)
        for z, Dz in zip(t, Dt):
            if 0 in z.shape:
                continue
            alpha = jnp.minimum(alpha, tau * _min_ratio(z, Dz))
        for z, Dz in zip(lam, Dlam):
            if 0 in z.shape:
                continue
            alpha = jnp.minimum(alpha, tau * _min_ratio(z, Dz))

        step_ok = (jnp.isfinite(alpha)
                   & jnp.all(jnp.isfinite(Ddx), axis=(0, 1))
                   & jnp.all(jnp.isfinite(Ddu), axis=(0, 1)))
        keep = (gap <= gap_floor) | ~step_ok
        alpha = jnp.where(keep, 0.0, alpha)
        av = alpha[None, None, :]

        new_primal = (dx + av * Ddx, du + av * Ddu,
                      (sl + av * Dsl) if nS else sl,
                      (su + av * Dsu) if nS else su)
        new_t = tuple(ti + av * Dti for ti, Dti in zip(t, Dt))
        new_l = tuple(li + av * Dli for li, Dli in zip(lam, Dlam))
        if centering == "adaptive":
            one_m = 1.0 - jnp.where(keep, 1.0, alpha)
            new_sigma = jnp.clip(one_m * one_m * one_m, 1e-3, 0.5)
        else:
            new_sigma = sigma_l
        return (new_primal, new_t, new_l, new_sigma), gap

    # fixed centering keeps the historical constant; adaptive starts
    # cautious (0.5) and lets the first step's alpha take over
    sigma0 = jnp.full((L,), sigma if centering == "fixed" else 0.5, dtype)
    carry = ((dx, du, sl, su), all_t, all_l, sigma0)
    carry, _gaps = jax.lax.scan(body, carry, None, length=iters)

    def lanes_sum(x):
        return jnp.sum(x, axis=tuple(range(x.ndim - 1)))

    if extra_iters:
        # ---- stall escalation: same Newton body, run only while some
        # lane is still above the gate (bounded by extra_iters).  The
        # cond's gap reduction is O(rows) elementwise work — negligible
        # next to one Riccati sweep — so fully-converged batches exit at
        # k=0 with zero extra sweeps.
        eff = tol if dtype == jnp.float64 else max(tol, 5e-7)
        stall = jnp.asarray(eff if stall_tol is None else stall_tol, dtype)

        def esc_cond(state):
            k, c = state
            _, t_c, lam_c, _ = c
            g = sum(lanes_sum(li * ti)
                    for li, ti in zip(lam_c, t_c)) / n_total
            # non-finite lanes are dead (status 2) — never escalate for
            # them, the cap would just be burned for nothing
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            return (k < extra_iters) & jnp.any(g > stall)

        def esc_body(state):
            k, c = state
            c, _ = body(c, None)
            return k + 1, c

        _, carry = jax.lax.while_loop(
            esc_cond, esc_body, (jnp.asarray(0, jnp.int32), carry))

    (dx, du, sl, su), t, lam, _ = carry

    gap = sum(lanes_sum(li * ti) for li, ti in zip(lam, t)) / n_total
    cbar = ln.smv(qp.A, dx[:-1]) + ln.smv(qp.B, du) + qp.c - dx[1:]
    eq_res = jnp.max(jnp.abs(cbar), axis=(0, 1))
    eq_res = jnp.maximum(eq_res, jnp.max(jnp.abs(qp.dx0 - dx[0]), axis=0))

    # eq_res participates: a NaN-poisoned lane (e.g. NaN measurement in
    # dx0) can freeze at a finite iterate while its residual is NaN —
    # that lane must report status 2, not 1 (same rule as ops/ipm.py)
    finite = (jnp.isfinite(gap) & jnp.isfinite(eq_res)
              & jnp.all(jnp.isfinite(dx), axis=(0, 1))
              & jnp.all(jnp.isfinite(du), axis=(0, 1)))
    # status tolerance is dtype-aware: in float32 the gap floors at
    # ~3e-7, so a 1e-7 request would label fully-converged solves as
    # status 1 (observed in bench/CLI runs); the freeze threshold
    # above is unchanged
    eff_tol = tol if dtype == jnp.float64 else max(tol, 5e-7)
    converged = (gap < eff_tol) & (eq_res < 1e3 * eff_tol)
    status = jnp.where(finite, jnp.where(converged, 0, 1), 2).astype(jnp.int32)
    sol = LaneIPMSolution(dx=dx, du=du, gap=gap, eq_res=eq_res, status=status)
    if return_gap_trace:
        return sol, _gaps        # (iters, L) per-iteration duality gaps
    return sol
