"""Dense QP engine over a fully condensed problem — the qpOASES role.

The reference ships qpOASES as its alternative dense QP solver (SURVEY.md
section 2.1 N4; enabled with -DACADOS_WITH_QPOASES=ON, reference README.md:33,
and selectable as the commented ``FULL_CONDENSING_QPOASES`` at
scripts/usv_guidance_ca1/acados_settings.py:189).  qpOASES is an online
active-set method; active-set working-set updates are data-dependent control
flow, which is exactly what a traced XLA program cannot express without
recompilation.  The accelerator-idiomatic engine with the same role — an independent
second QP path over the *condensed* problem, useful for cross-checking the
stagewise Riccati engine and for problems with short horizons — is a dense
primal-dual interior-point method:

- condensing (ops/condense.py) removes every equality constraint, so each
  IPM iteration reduces to ONE dense symmetric solve of size (N*nu, N*nu),
  a single dense Cholesky factorization instead of a Riccati sweep;
- soft-constraint slacks are eliminated analytically with the same
  zl/Zl/lsh/ush semantics as ops/ipm.py, so the two engines solve literally
  the same KKT system and agree to solver tolerance (tests/test_dense_qp.py);
- a fixed iteration count keeps the whole solve one straight-line program,
  vmappable over scenario batches.

Complexity note: the dense engine is O(N^3 nu^3) per iteration versus the
Riccati engine's O(N (nx+nu)^3), so it wins only for short horizons or as an
independent check — the same trade acados documents between full condensing
(qpOASES) and partial condensing (HPIPM).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_collisionavoidance_tpu.ops.condense import DenseQP, condense, expand
from mpc_collisionavoidance_tpu.ops.ipm import IPMSolution, QPData


class DenseIPMSolution(NamedTuple):
    w: jnp.ndarray       # (nz,) stacked controls
    sl: jnp.ndarray      # (mS,)
    su: jnp.ndarray      # (mS,)
    gap: jnp.ndarray     # final complementarity
    status: jnp.ndarray  # 0 ok, 1 not converged, 2 NaN


def dense_ipm_solve(d: DenseQP, iters: int = 18, tau: float = 0.995,
                    sigma: float = 0.1, tol: float = 1e-7,
                    mu0: float = 1.0) -> DenseIPMSolution:
    """Path-following IPM on the condensed QP (fixed iteration count)."""
    nz = d.g.shape[0]
    mI = d.dg.shape[0]
    mS = d.dc.shape[0]
    dtype = d.H.dtype
    n_total = max(mI + 4 * mS, 1)

    w = jnp.zeros((nz,), dtype)
    gv0 = d.dc
    s_margin = jnp.asarray(0.1, dtype)
    sl = jnp.maximum(d.slh - gv0, d.lsh) + s_margin
    su = jnp.maximum(gv0 - d.suh, d.ush) + s_margin
    t_min = jnp.asarray(0.1, dtype)
    tg = jnp.maximum(d.dg, t_min)
    tl = jnp.maximum(gv0 - d.slh + sl, t_min)
    tu = jnp.maximum(d.suh - gv0 + su, t_min)
    tsl = jnp.maximum(sl - d.lsh, t_min)
    tsu = jnp.maximum(su - d.ush, t_min)
    lg, ll, lu, lsl, lsu = (mu0 / t for t in (tg, tl, tu, tsl, tsu))

    gap_floor = jnp.asarray(1e-13 if dtype == jnp.float64 else 3e-7, dtype)
    # Cholesky regularization: the condensed Hessian accumulates roundoff
    # over N stages of propagation, so a tiny diagonal shift keeps the
    # factorization positive definite near convergence.
    reg = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)
    eye = jnp.eye(nz, dtype=dtype)

    def body(carry, _):
        w, sl, su, tg, tl, tu, tsl, tsu, lg, ll, lu, lsl, lsu = carry

        gv = d.Chat @ w + d.dc
        r_tg = (d.Ghat @ w + d.dg) - tg
        r_tl = (gv - d.slh + sl) - tl
        r_tu = (d.suh - gv + su) - tu
        r_tsl = (sl - d.lsh) - tsl
        r_tsu = (su - d.ush) - tsu

        gap = (jnp.sum(lg * tg) + jnp.sum(ll * tl) + jnp.sum(lu * tu)
               + jnp.sum(lsl * tsl) + jnp.sum(lsu * tsu)) / n_total
        mu = sigma * gap

        ag = lg / tg
        al, au, asl, asu = ll / tl, lu / tu, lsl / tsl, lsu / tsu

        beta_l = d.Zl + al + asl
        beta_u = d.Zu + au + asu
        k_l = mu / tl + mu / tsl - d.zl - d.Zl * sl - al * r_tl - asl * r_tsl
        k_u = mu / tu + mu / tsu - d.zu - d.Zu * su - au * r_tu - asu * r_tsu
        abar_l = al * (d.Zl + asl) / beta_l
        abar_u = au * (d.Zu + asu) / beta_u
        qtil_l = mu / tl - al * r_tl - al * k_l / beta_l
        qtil_u = mu / tu - au * r_tu - au * k_u / beta_u

        # dense Newton system: (H + G'AgG + C'(Al+Au)C) Dw = -rhs.
        # Near convergence the active-row weights ag blow up, so the raw
        # system is too ill-conditioned for a float32 Cholesky; Jacobi
        # equilibration plus one iterative-refinement step recovers the
        # digits (this conditioning gap is exactly why acados defaults to
        # partial condensing over the full-condensing qpOASES path).
        Heff = ((d.Ghat.T * ag) @ d.Ghat
                + (d.Chat.T * (abar_l + abar_u)) @ d.Chat + d.H)
        hard_vec = mu / tg - ag * r_tg
        rhs = (d.g + d.H @ w
               - d.Ghat.T @ hard_vec
               - d.Chat.T @ qtil_l + d.Chat.T @ qtil_u)
        dscale = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(Heff),
                                           jnp.asarray(1e-30, dtype)))
        Hs = Heff * dscale[:, None] * dscale[None, :] + reg * eye
        chol = jax.scipy.linalg.cho_factor(Hs, lower=True)

        def nsolve(b):
            return dscale * jax.scipy.linalg.cho_solve(chol, dscale * b)

        Dw = nsolve(-rhs)
        Dw = Dw - nsolve(Heff @ Dw + rhs)   # one refinement step

        Dgv = d.Chat @ Dw
        Dsl = (k_l - al * Dgv) / beta_l
        Dsu = (k_u + au * Dgv) / beta_u
        Dtg = d.Ghat @ Dw + r_tg
        Dtl = Dgv + Dsl + r_tl
        Dtu = -Dgv + Dsu + r_tu
        Dtsl = Dsl + r_tsl
        Dtsu = Dsu + r_tsu
        Dlg = (mu - lg * tg) / tg - ag * Dtg
        Dll = (mu - ll * tl) / tl - al * Dtl
        Dlu = (mu - lu * tu) / tu - au * Dtu
        Dlsl = (mu - lsl * tsl) / tsl - asl * Dtsl
        Dlsu = (mu - lsu * tsu) / tsu - asu * Dtsu

        def ratio(z, Dz):
            r = jnp.where(Dz < 0, -z / jnp.where(Dz < 0, Dz, -1.0), jnp.inf)
            return jnp.min(r, initial=jnp.inf)

        alpha_max = jnp.minimum(
            jnp.minimum(jnp.minimum(ratio(tg, Dtg), ratio(tl, Dtl)),
                        jnp.minimum(ratio(tu, Dtu), ratio(tsl, Dtsl))),
            jnp.minimum(jnp.minimum(ratio(tsu, Dtsu), ratio(lg, Dlg)),
                        jnp.minimum(jnp.minimum(ratio(ll, Dll),
                                                ratio(lu, Dlu)),
                                    jnp.minimum(ratio(lsl, Dlsl),
                                                ratio(lsu, Dlsu)))),
        )
        alpha = jnp.minimum(1.0, tau * alpha_max).astype(dtype)

        step_ok = jnp.isfinite(alpha) & jnp.all(jnp.isfinite(Dw))
        keep = (gap <= gap_floor) | ~step_ok

        def upd(old, delta):
            return jnp.where(keep, old, old + alpha * delta)

        new = (upd(w, Dw), upd(sl, Dsl), upd(su, Dsu),
               upd(tg, Dtg), upd(tl, Dtl), upd(tu, Dtu),
               upd(tsl, Dtsl), upd(tsu, Dtsu),
               upd(lg, Dlg), upd(ll, Dll), upd(lu, Dlu),
               upd(lsl, Dlsl), upd(lsu, Dlsu))
        return new, gap

    carry = (w, sl, su, tg, tl, tu, tsl, tsu, lg, ll, lu, lsl, lsu)
    carry, _ = jax.lax.scan(body, carry, None, length=iters)
    w, sl, su, tg, tl, tu, tsl, tsu, lg, ll, lu, lsl, lsu = carry

    gap = (jnp.sum(lg * tg) + jnp.sum(ll * tl) + jnp.sum(lu * tu)
           + jnp.sum(lsl * tsl) + jnp.sum(lsu * tsu)) / n_total
    finite = jnp.isfinite(gap) & jnp.all(jnp.isfinite(w))
    eff_tol = tol if dtype == jnp.float64 else max(tol, 5e-7)
    status = jnp.where(finite, jnp.where(gap < eff_tol, 0, 1), 2)
    return DenseIPMSolution(w=w, sl=sl, su=su, gap=gap, status=status)


def dense_qp_solve(qp: QPData, iters: int = 18, tol: float = 1e-7
                   ) -> IPMSolution:
    """Drop-in alternative to ops.ipm.ipm_solve via full condensing.

    Same QPData in, same IPMSolution out — the solver backend switch the
    reference exposes as qp_solver = PARTIAL_CONDENSING_HPIPM vs
    FULL_CONDENSING_QPOASES (scripts/usv_guidance_ca1/
    acados_settings.py:189-190).
    """
    N, _, nu = qp.B.shape
    nS = qp.hofs.shape[-1]
    d = condense(qp)
    sol = dense_ipm_solve(d, iters=iters, tol=tol)
    dx, du = expand(d, sol.w, N, nu)
    # dynamics hold exactly by construction after condensing
    eq_res = jnp.zeros((), dx.dtype)
    # a NaN-poisoned problem (e.g. NaN dx0) freezes w at a finite value
    # but expands to non-finite dx — surface it as status 2, matching
    # ops/ipm.py semantics
    status = jnp.where(jnp.all(jnp.isfinite(dx)) & jnp.all(jnp.isfinite(du)),
                       sol.status, 2)
    return IPMSolution(dx=dx, du=du,
                       sl=sol.sl.reshape(N, nS), su=sol.su.reshape(N, nS),
                       gap=sol.gap, eq_res=eq_res, status=status)
