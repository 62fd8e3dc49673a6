"""Primal-dual interior-point method for stage-structured QPs with soft
constraints — the accelerator-native role of HPIPM (reference qp_solver
"PARTIAL_CONDENSING_HPIPM", scripts/usv_guidance_ca1/acados_settings.py:190).

QP form (per SQP iteration, all quantities from linearization at the current
trajectory iterate):

    min   sum_k 0.5 w_k'H_k w_k + g_k'w_k
          + sum_k [ zl'sl_k + 0.5 sl_k'Zl sl_k + zu'su_k + 0.5 su_k'Zu su_k ]
    s.t.  dx_{k+1} = A_k dx_k + B_k du_k + c_k,      dx_0 = dx0
          Gx_k dx_k + Gu_k du_k - gl_k >= 0                       (hard rows)
          hofs_k + Cx_k dx_k - slh_k + sl_k >= 0                  (soft lower)
          suh_k - hofs_k - Cx_k dx_k + su_k >= 0                  (soft upper)
          sl_k >= lsh,  su_k >= ush                               (slack bounds)

matching acados/HPIPM soft-constraint semantics (zl/Zl/zu/Zu slack costs and
lsh/ush slack bounds, reference scripts/usv_guidance_ca1/
acados_settings.py:105-108,154-178).

Algorithm: infeasible-start primal-dual path following with
- slack/dual elimination of every inequality family into a modified stage
  Hessian/gradient (the HPIPM "soft constraint elimination"),
- one Riccati `lax.scan` sweep per IPM iteration (ops/riccati.py),
- a single fraction-to-boundary step size per instance,
- a FIXED iteration count so the whole solve is one straight-line XLA
  program: `vmap` over thousands of scenario instances gives batched
  solves with zero host round-trips (the reference's one-solve-per-tick
  CPU loop, src/nmpc_guidance_ca1.cpp:577, becomes a tensor program).

All inequality slacks t are independent variables (infeasible start is
allowed); residuals r_t = g(w) - t contract by (1-alpha) per iteration.
Masked (absent) hard rows are encoded as zero rows with gl = -1 so they
contribute exactly nothing while keeping shapes static.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_collisionavoidance_tpu.ops.riccati import LQRData, lqr_solve


class QPData(NamedTuple):
    """Stage-structured QP with hard rows and softened rows."""

    # dynamics
    A: jnp.ndarray     # (N, nx, nx)
    B: jnp.ndarray     # (N, nx, nu)
    c: jnp.ndarray     # (N, nx)
    dx0: jnp.ndarray   # (nx,)
    # cost
    Q: jnp.ndarray     # (N+1, nx, nx)
    S: jnp.ndarray     # (N, nu, nx)
    R: jnp.ndarray     # (N, nu, nu)
    qx: jnp.ndarray    # (N+1, nx)
    qu: jnp.ndarray    # (N, nu)
    # hard inequality rows: Gx dx + Gu du - gl >= 0
    Gx: jnp.ndarray    # (N, nI, nx)
    Gu: jnp.ndarray    # (N, nI, nu)
    gl: jnp.ndarray    # (N, nI)
    # soft rows: value g = hofs + Cx dx, relaxed slh <= g <= suh
    Cx: jnp.ndarray    # (N, nS, nx)
    hofs: jnp.ndarray  # (N, nS)
    slh: jnp.ndarray   # (N, nS)
    suh: jnp.ndarray   # (N, nS)
    zl: jnp.ndarray    # (nS,) linear lower-slack cost (already dt-scaled)
    Zl: jnp.ndarray    # (nS,)
    zu: jnp.ndarray    # (nS,)
    Zu: jnp.ndarray    # (nS,)
    lsh: jnp.ndarray   # (nS,) slack lower bounds
    ush: jnp.ndarray   # (nS,)


class IPMSolution(NamedTuple):
    dx: jnp.ndarray        # (N+1, nx)
    du: jnp.ndarray        # (N, nu)
    sl: jnp.ndarray        # (N, nS) lower slacks
    su: jnp.ndarray        # (N, nS)
    gap: jnp.ndarray       # final complementarity measure (scalar)
    eq_res: jnp.ndarray    # final dynamics residual inf-norm (scalar)
    status: jnp.ndarray    # 0 ok, 1 not converged, 2 NaN


def _bmv(M, v):
    """Batched (stage-wise) matrix-vector: (N,a,b) x (N,b) -> (N,a)."""
    return jnp.einsum("kab,kb->ka", M, v)


def _bmtv(M, v):
    """(N,a,b) x (N,a) -> (N,b)  (transpose matvec)."""
    return jnp.einsum("kab,ka->kb", M, v)


def _weighted_gram(M, w, Mb=None):
    """(N,r,a),(N,r)[,(N,r,b)] -> sum_i w_i M_i M_i' : (N,a,b)."""
    Mb = M if Mb is None else Mb
    return jnp.einsum("kra,kr,krb->kab", M, w, Mb)


def ipm_solve(qp: QPData, iters: int = 18, tau: float = 0.995,
              sigma: float = 0.1, tol: float = 1e-7,
              mu0: float = 1.0, centering: str = "fixed") -> IPMSolution:
    """Solve the QP with `iters` fixed path-following iterations.

    `centering="mehrotra"` runs the full Mehrotra predictor-corrector:
    each iteration first solves the affine system (sigma = 0), sets
    sigma = (mu_aff / mu)^3 from the probe's fraction-to-boundary step,
    and re-solves with the second-order correction Dt_aff*Dlam_aff on
    the complementarity right-hand side — 2 Riccati sweeps per
    iteration, but far fewer iterations on ill-conditioned weights
    (HPIPM's own predictor-corrector schedule; the reference inherits
    it through qp_solver PARTIAL_CONDENSING_HPIPM).

    `mu0="auto"` scales the initial barrier weight to the QP's gradient
    magnitude instead of the constant 1.0.  With 1e5-scale cost weights
    (usv_position_control) the true active-set multipliers are ~1e4-1e6;
    starting the duals at mu0/t = 10 forces ~20 iterations of pure dual
    growth (measured: the duality gap plateaus at ~0.8 until iteration
    ~25) before the path-following can contract.  Gradient-proportional
    mu0 removes the plateau: fixed@18 and mehrotra@12 both converge
    where mu0=1.0 needed 30."""
    if centering not in ("fixed", "mehrotra"):
        raise ValueError(f"unknown centering '{centering}'")
    N, nI = qp.gl.shape
    if isinstance(mu0, str):
        if mu0 != "auto":
            raise ValueError(f"unknown mu0 '{mu0}'")
        g_scale = jnp.maximum(jnp.max(jnp.abs(qp.qx)),
                              jnp.max(jnp.abs(qp.qu)))
        mu0 = jnp.clip(0.01 * g_scale, 1.0, 1e6)
    nS = qp.hofs.shape[-1]
    dtype = qp.A.dtype
    n_total = N * (nI + 4 * nS)
    n_total = max(n_total, 1)

    def g_hard(dx, du):
        return _bmv(qp.Gx, dx[:-1]) + _bmv(qp.Gu, du) - qp.gl

    def g_soft_val(dx):
        return qp.hofs + _bmv(qp.Cx, dx[:-1])

    # ----- initialization -----
    dx = jnp.zeros((N + 1, qp.A.shape[-1]), dtype)
    du = jnp.zeros((N, qp.B.shape[-1]), dtype)
    gv0 = g_soft_val(dx)
    s_margin = jnp.asarray(0.1, dtype)
    sl = jnp.maximum(qp.slh - gv0, qp.lsh) + s_margin
    su = jnp.maximum(gv0 - qp.suh, qp.ush) + s_margin
    t_min = jnp.asarray(0.1, dtype)
    tg = jnp.maximum(g_hard(dx, du), t_min)
    tl = jnp.maximum(gv0 - qp.slh + sl, t_min)
    tu = jnp.maximum(qp.suh - gv0 + su, t_min)
    tsl = jnp.maximum(sl - qp.lsh, t_min)
    tsu = jnp.maximum(su - qp.ush, t_min)
    lg, ll, lu, lsl, lsu = (mu0 / t for t in (tg, tl, tu, tsl, tsu))

    # Once the duality measure reaches this floor the iterate is frozen:
    # pushing an IPM past ~sqrt(eps) of the dtype makes lambda/t ratios
    # overflow for active rows and poisons the solution with NaNs.
    gap_floor = jnp.asarray(1e-13 if dtype == jnp.float64 else 3e-7, dtype)

    def body(carry, _):
        dx, du, sl, su, tg, tl, tu, tsl, tsu, lg, ll, lu, lsl, lsu = carry

        gv = g_soft_val(dx)
        r_tg = g_hard(dx, du) - tg
        r_tl = (gv - qp.slh + sl) - tl
        r_tu = (qp.suh - gv + su) - tu
        r_tsl = (sl - qp.lsh) - tsl
        r_tsu = (su - qp.ush) - tsu

        gap = (jnp.sum(lg * tg) + jnp.sum(ll * tl) + jnp.sum(lu * tu)
               + jnp.sum(lsl * tsl) + jnp.sum(lsu * tsu)) / n_total

        ag = lg / tg
        al, au, asl, asu = ll / tl, lu / tu, lsl / tsl, lsu / tsu

        # mu-independent soft-row elimination scalars
        beta_l = qp.Zl + al + asl
        beta_u = qp.Zu + au + asu
        abar_l = al * (qp.Zl + asl) / beta_l
        abar_u = au * (qp.Zu + asu) / beta_u

        # modified stage Hessians (mu-independent)
        Qbar_path = (qp.Q[:-1]
                     + _weighted_gram(qp.Gx, ag)
                     + _weighted_gram(qp.Cx, abar_l + abar_u))
        Qbar = jnp.concatenate([Qbar_path, qp.Q[-1:]], axis=0)
        Rbar = qp.R + _weighted_gram(qp.Gu, ag)
        Sbar = qp.S + jnp.einsum("kru,kr,krx->kux", qp.Gu, ag, qp.Gx)

        # mu-independent gradient bases + dynamics residuals
        qx_base = qp.qx[:-1] + _bmv(qp.Q[:-1], dx[:-1]) + _bmtv(qp.S, du)
        qx_N = qp.qx[-1] + qp.Q[-1] @ dx[-1]
        qu_base = qp.qu + _bmv(qp.S, dx[:-1]) + _bmv(qp.R, du)
        cbar = _bmv(qp.A, dx[:-1]) + _bmv(qp.B, du) + qp.c - dx[1:]
        ddx0 = qp.dx0 - dx[0]

        def newton(m_tg, m_tl, m_tu, m_tsl, m_tsu):
            """Newton direction for per-family complementarity targets m:
            T dlam + Lam dt = m - Lam T e.  m = sigma*mu reproduces the
            plain centering step; m = 0 is Mehrotra's affine probe;
            m = sigma*mu - Dt_aff*Dlam_aff the corrector."""
            k_l = (m_tl / tl + m_tsl / tsl - qp.zl - qp.Zl * sl
                   - al * r_tl - asl * r_tsl)
            k_u = (m_tu / tu + m_tsu / tsu - qp.zu - qp.Zu * su
                   - au * r_tu - asu * r_tsu)
            qtil_l = m_tl / tl - al * r_tl - al * k_l / beta_l
            qtil_u = m_tu / tu - au * r_tu - au * k_u / beta_u

            hard_vec = m_tg / tg - ag * r_tg
            qx_path = (qx_base
                       - _bmtv(qp.Gx, hard_vec)
                       - _bmtv(qp.Cx, qtil_l) + _bmtv(qp.Cx, qtil_u))
            qxbar = jnp.concatenate([qx_path, qx_N[None]], axis=0)
            qubar = qu_base - _bmtv(qp.Gu, hard_vec)

            Ddx, Ddu = lqr_solve(LQRData(qp.A, qp.B, cbar, Qbar, Sbar, Rbar,
                                         qxbar, qubar, ddx0))

            # recover slack and dual steps
            Dgv = _bmv(qp.Cx, Ddx[:-1])
            Dsl = (k_l - al * Dgv) / beta_l
            Dsu = (k_u + au * Dgv) / beta_u
            Dtg = _bmv(qp.Gx, Ddx[:-1]) + _bmv(qp.Gu, Ddu) + r_tg
            Dtl = Dgv + Dsl + r_tl
            Dtu = -Dgv + Dsu + r_tu
            Dtsl = Dsl + r_tsl
            Dtsu = Dsu + r_tsu
            Dlg = (m_tg - lg * tg) / tg - ag * Dtg
            Dll = (m_tl - ll * tl) / tl - al * Dtl
            Dlu = (m_tu - lu * tu) / tu - au * Dtu
            Dlsl = (m_tsl - lsl * tsl) / tsl - asl * Dtsl
            Dlsu = (m_tsu - lsu * tsu) / tsu - asu * Dtsu
            return (Ddx, Ddu, Dsl, Dsu, (Dtg, Dtl, Dtu, Dtsl, Dtsu),
                    (Dlg, Dll, Dlu, Dlsl, Dlsu))

        # fraction-to-boundary step size (single alpha per instance)
        def ratio(z, Dz):
            r = jnp.where(Dz < 0, -z / jnp.where(Dz < 0, Dz, -1.0), jnp.inf)
            return jnp.min(r, initial=jnp.inf)

        ts = (tg, tl, tu, tsl, tsu)
        ls = (lg, ll, lu, lsl, lsu)
        if centering == "mehrotra":
            # ---- affine probe (sigma = 0) ----
            z = jnp.zeros((), dtype)
            Ddx_a, Ddu_a, _, _, Dts_a, Dls_a = newton(z, z, z, z, z)
            alpha_a = jnp.asarray(1.0, dtype)
            for zv, Dz in zip(ts + ls, Dts_a + Dls_a):
                alpha_a = jnp.minimum(alpha_a, ratio(zv, Dz))
            mu_aff = sum(
                jnp.sum((li + alpha_a * Dli) * (ti + alpha_a * Dti))
                for li, ti, Dli, Dti in zip(ls, ts, Dls_a, Dts_a)) / n_total
            mu_aff = jnp.maximum(mu_aff, 0.0)
            aff_ok = (jnp.isfinite(mu_aff) & jnp.isfinite(alpha_a)
                      & jnp.all(jnp.isfinite(Ddx_a))
                      & jnp.all(jnp.isfinite(Ddu_a)))
            r3 = mu_aff / jnp.maximum(gap, gap_floor)
            sig = jnp.clip(r3 * r3 * r3, 1e-4, 0.99)
            sig = jnp.where(aff_ok, sig, 0.5)    # plain centering fallback
            # corrector: sigma*mu minus the second-order term Dt_aff*Dl_aff
            ms = tuple(
                jnp.where(aff_ok, sig * gap - Dti * Dli, 0.5 * gap)
                for Dti, Dli in zip(Dts_a, Dls_a))
            Ddx, Ddu, Dsl, Dsu, Dts, Dls = newton(*ms)
        else:
            mu = sigma * gap
            Ddx, Ddu, Dsl, Dsu, Dts, Dls = newton(mu, mu, mu, mu, mu)
        Dtg, Dtl, Dtu, Dtsl, Dtsu = Dts
        Dlg, Dll, Dlu, Dlsl, Dlsu = Dls

        alpha_max = jnp.minimum(
            jnp.minimum(jnp.minimum(ratio(tg, Dtg), ratio(tl, Dtl)),
                        jnp.minimum(ratio(tu, Dtu), ratio(tsl, Dtsl))),
            jnp.minimum(jnp.minimum(ratio(tsu, Dtsu), ratio(lg, Dlg)),
                        jnp.minimum(jnp.minimum(ratio(ll, Dll), ratio(lu, Dlu)),
                                    jnp.minimum(ratio(lsl, Dlsl),
                                                ratio(lsu, Dlsu)))),
        )
        alpha = jnp.minimum(1.0, tau * alpha_max).astype(dtype)

        # freeze the iterate once converged (see gap_floor note above); a
        # NaN-poisoned step is also rejected so earlier progress survives
        step_ok = jnp.isfinite(alpha) & jnp.all(jnp.isfinite(Ddx)) \
            & jnp.all(jnp.isfinite(Ddu))
        keep = (gap <= gap_floor) | ~step_ok

        def upd(old, delta):
            return jnp.where(keep, old, old + alpha * delta)

        new = (upd(dx, Ddx), upd(du, Ddu),
               upd(sl, Dsl), upd(su, Dsu),
               upd(tg, Dtg), upd(tl, Dtl), upd(tu, Dtu),
               upd(tsl, Dtsl), upd(tsu, Dtsu),
               upd(lg, Dlg), upd(ll, Dll), upd(lu, Dlu),
               upd(lsl, Dlsl), upd(lsu, Dlsu))
        return new, gap

    carry = (dx, du, sl, su, tg, tl, tu, tsl, tsu, lg, ll, lu, lsl, lsu)
    carry, gaps = jax.lax.scan(body, carry, None, length=iters)
    dx, du, sl, su, tg, tl, tu, tsl, tsu, lg, ll, lu, lsl, lsu = carry

    gap = (jnp.sum(lg * tg) + jnp.sum(ll * tl) + jnp.sum(lu * tu)
           + jnp.sum(lsl * tsl) + jnp.sum(lsu * tsu)) / n_total
    cbar = _bmv(qp.A, dx[:-1]) + _bmv(qp.B, du) + qp.c - dx[1:]
    eq_res = jnp.max(jnp.abs(cbar), initial=0.0)
    eq_res = jnp.maximum(eq_res, jnp.max(jnp.abs(qp.dx0 - dx[0]), initial=0.0))

    # eq_res participates: a NaN-poisoned problem (e.g. NaN measurement in
    # dx0) freezes the iterate at a finite value but leaves a non-finite
    # residual — that must surface as status 2, not "merely unconverged"
    finite = (jnp.isfinite(gap) & jnp.isfinite(eq_res)
              & jnp.all(jnp.isfinite(dx)) & jnp.all(jnp.isfinite(du)))
    # status tolerance is dtype-aware: in float32 the gap floors at
    # ~3e-7, so a 1e-7 request would label fully-converged solves as
    # status 1 (observed in bench/CLI runs); the freeze threshold
    # above is unchanged
    eff_tol = tol if dtype == jnp.float64 else max(tol, 5e-7)
    converged = (gap < eff_tol) & (eq_res < 1e3 * eff_tol)
    status = jnp.where(finite, jnp.where(converged, 0, 1), 2)
    return IPMSolution(dx=dx, du=du, sl=sl, su=su, gap=gap,
                       eq_res=eq_res, status=status)
