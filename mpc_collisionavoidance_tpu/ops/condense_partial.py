"""Partial condensing of lane-batched stage QPs (the HPIPM role).

The reference solves its QPs with `PARTIAL_CONDENSING_HPIPM`
(scripts/usv_guidance_ca1/acados_settings.py:190): groups of consecutive
shooting intervals are condensed into macro-stages before the Riccati IPM,
trading a shorter (better-latency) recursion for denser per-stage blocks.
On an accelerator that trade is MORE valuable than on CPU: the Riccati sweep is 2N
*sequential* dependent small ops whose dispatch latency dominates their
arithmetic (docs/PERF.md bound #2), while the extra dense-block FLOPs are
elementwise batch work the lane layout is already good at.

Given the full-resolution :class:`LaneQP` built by `solver/batch.py`
(static 2-D cost blocks, state-only constraint rows) and a group size M
dividing N, :func:`condense_lane_qp` returns an equivalent LaneQP over
N' = N/M macro-stages where

- the macro state is the group-start state dz_g = dx_{gM}, the macro
  control w_g stacks the group's M stage controls (j-major),
- intra-group states are eliminated through the linearized dynamics:
  dx_{gM+j} = E_j dz + G_j w + e_j with E_0 = I, G_0 = 0, e_0 = 0 and
  E_{j+1} = A_j E_j, G_{j+1} = A_j G_j + B_j P_j, e_{j+1} = A_j e_j + c_j,
- stage costs become stage/lane-varying dense (Qc', Sc', Rc') blocks
  (4-D; ops/ipm_lanes.py accepts both forms),
- control boxes stay boxes (macro index set = the per-stage set tiled),
- state boxes at interior stages and all h rows become general rows
  C' dz + D' w + offset carried in the (extended) hard/soft families
  with the new `Dh`/`Ds` control-coupling blocks,
- the soft-row slack machinery is preserved row-for-row (weights tiled
  j-major), so soft-constraint semantics are bit-identical to acados'
  zl/Zl/lsh/ush handling at full resolution.

:func:`expand_solution` recovers the full-resolution primal trajectory
from the macro solution by re-running the (exact, linear) intra-group
recursion — the same expansion HPIPM performs after its condensed solve.
"""

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from mpc_collisionavoidance_tpu.ops.ipm_lanes import LaneQP


# ---- group-batched tiny-matrix helpers (leading group axis, trailing
# lane axis; same unrolled broadcast-multiply-reduce idiom as ops/lanes) --

def _gmm(X, Y):
    """(G,m,k,L) @ (G,k,n,L) -> (G,m,n,L)."""
    return jnp.sum(X[:, :, :, None, :] * Y[:, None, :, :, :], axis=2)


def _gtm(X, Y):
    """X^T Y: (G,k,m,L) , (G,k,n,L) -> (G,m,n,L)."""
    return jnp.sum(X[:, :, :, None, :] * Y[:, :, None, :, :], axis=1)


def _gmv(X, v):
    """(G,m,k,L) @ (G,k,L) -> (G,m,L)."""
    return jnp.sum(X * v[:, None, :, :], axis=2)


def _gtv(X, v):
    """X^T v: (G,k,m,L) , (G,k,L) -> (G,m,L)."""
    return jnp.sum(X * v[:, :, None, :], axis=1)


def _smm(Ms, Y):
    """static (m,k) @ (G,k,n,L) -> (G,m,n,L)."""
    return jnp.sum(Ms[None, :, :, None, None] * Y[:, None, :, :, :], axis=2)


def _smv(Ms, v):
    """static (m,k) @ (G,k,L) -> (G,m,L)."""
    return jnp.sum(Ms[None, :, :, None] * v[:, None, :, :], axis=2)


def _rows_m(Cr, E):
    """(G,r,a,L) @ (G,a,b,L) -> (G,r,b,L)  (constraint rows x transition)."""
    return jnp.sum(Cr[:, :, :, None, :] * E[:, None, :, :, :], axis=2)


def _rows_v(Cr, v):
    """(G,r,a,L) , (G,a,L) -> (G,r,L)."""
    return jnp.sum(Cr * v[:, None, :, :], axis=2)


class CondenseAux(NamedTuple):
    """Full-resolution dynamics kept for :func:`expand_solution`."""
    A: jnp.ndarray   # (G, M, nx, nx, L)
    B: jnp.ndarray   # (G, M, nx, nu, L)
    c: jnp.ndarray   # (G, M, nx, L)
    M: int
    nu: int


def condense_lane_qp(qp: LaneQP, M: int,
                     idxbu: Tuple[int, ...],
                     idxbx: Tuple[int, ...]):
    """Condense `qp` by group size M.  Returns (qp_macro, idxbu_macro,
    aux).  Requires the full-resolution form produced by
    `LaneRTISolver._build_qp`: static 2-D cost blocks and state-only rows.
    """
    N, nx, nu, L = qp.B.shape[0], qp.A.shape[1], qp.B.shape[2], qp.B.shape[-1]
    if N % M != 0:
        raise ValueError(f"group size {M} does not divide horizon {N}")
    if qp.Qc.ndim != 2 or qp.Dh is not None or qp.Ds is not None:
        raise ValueError("condense_lane_qp expects a full-resolution QP "
                         "(static cost blocks, state-only rows)")
    G = N // M
    nw = M * nu
    dtype = qp.A.dtype
    nbu, nbx = len(idxbu), len(idxbx)
    nHh = qp.Ch.shape[1]
    nS = qp.Cs.shape[1]

    def grp(x):
        """(N, ...) -> (G, M, ...)."""
        return x.reshape((G, M) + x.shape[1:])

    A, B, c = grp(qp.A), grp(qp.B), grp(qp.c)
    qx_p, qu = grp(qp.qx[:-1]), grp(qp.qu)
    Qc = jnp.asarray(qp.Qc, dtype)
    Sc = jnp.asarray(qp.Sc, dtype)
    Rc = jnp.asarray(qp.Rc, dtype)

    # ---- intra-group transition chain ----
    E = jnp.broadcast_to(jnp.eye(nx, dtype=dtype)[None, :, :, None],
                         (G, nx, nx, L))
    Gm = jnp.zeros((G, nx, nw, L), dtype)
    e = jnp.zeros((G, nx, L), dtype)

    Qg = jnp.zeros((G, nx, nx, L), dtype)
    Sg = jnp.zeros((G, nw, nx, L), dtype)
    Rg = jnp.zeros((G, nw, nw, L), dtype)
    qxg = jnp.zeros((G, nx, L), dtype)
    qug = jnp.zeros((G, nw, L), dtype)

    Ch_parts, Dh_parts, hlo_parts, hhi_parts = [], [], [], []
    Cs_parts, Ds_parts, hofs_parts, slh_parts, suh_parts = [], [], [], [], []

    bu = np.asarray(idxbu, dtype=np.int64)
    bx = np.asarray(idxbx, dtype=np.int64)

    for j in range(M):
        # ---- cost contribution of stage j ----
        QE = _smm(Qc, E)                       # (G, nx, nx, L) = Q E_j
        QG = _smm(Qc, Gm)                      # (G, nx, nw, L) = Q G_j
        SE = _smm(Sc, E)                       # (G, nu, nx, L) = S E_j
        SG = _smm(Sc, Gm)                      # (G, nu, nw, L) = S G_j
        Qg = Qg + _gtm(E, QE)
        Sg = Sg + _gtm(Gm, QE)
        Sg = Sg.at[:, j * nu:(j + 1) * nu].add(SE)
        Rg = Rg + _gtm(Gm, QG)
        Rg = Rg.at[:, j * nu:(j + 1) * nu].add(SG)
        Rg = Rg.at[:, :, j * nu:(j + 1) * nu].add(
            jnp.swapaxes(SG, 1, 2))
        Rg = Rg.at[:, j * nu:(j + 1) * nu, j * nu:(j + 1) * nu].add(
            Rc[None, :, :, None])
        gvec = qx_p[:, j] + _smv(Qc, e)        # (G, nx, L)
        qxg = qxg + _gtv(E, gvec)
        qug = qug + _gtv(Gm, gvec)
        qug = qug.at[:, j * nu:(j + 1) * nu].add(
            qu[:, j] + _smv(Sc, e))

        # ---- h rows of stage j (hard) ----
        if nHh:
            Chj = grp(qp.Ch)[:, j]             # (G, nHh, nx, L)
            Ch_parts.append(_rows_m(Chj, E))
            Dh_parts.append(_rows_m(Chj, Gm))
            corr = _rows_v(Chj, e)             # (G, nHh, L)
            hlo_parts.append(grp(qp.hh_lo)[:, j] - corr)
            hhi_parts.append(grp(qp.hh_hi)[:, j] + corr)

        # ---- hard state-box rows of stage j -> general hard rows ----
        if nbx:
            Cxj = E[:, bx]                     # (G, nbx, nx, L)
            Dxj = Gm[:, bx]                    # (G, nbx, nw, L)
            corr = e[:, bx]                    # (G, nbx, L)
            if j == 0:
                # global stage 0 (group 0, j=0) is pinned by dx0: its box
                # rows are inactive in the full QP (xmask); zero the row
                # and keep the builder's inactive band offsets (-1.0)
                mk = np.ones((G, 1, 1, 1), np.float32)
                mk[0] = 0.0
                mk = jnp.asarray(mk, dtype)
                Cxj = Cxj * mk
                Dxj = Dxj * mk
            Ch_parts.append(Cxj)
            Dh_parts.append(Dxj)
            hlo_parts.append(grp(qp.xb_lo)[:, j] - corr)
            hhi_parts.append(grp(qp.xb_hi)[:, j] + corr)

        # ---- soft rows of stage j ----
        if nS:
            Csj = grp(qp.Cs)[:, j]
            Cs_parts.append(_rows_m(Csj, E))
            Ds_parts.append(_rows_m(Csj, Gm))
            hofs_parts.append(grp(qp.hofs)[:, j] + _rows_v(Csj, e))
            slh_parts.append(grp(qp.slh)[:, j])
            suh_parts.append(grp(qp.suh)[:, j])

        # ---- advance the chain: E_{j+1}, G_{j+1}, e_{j+1} ----
        Aj, Bj, cj = A[:, j], B[:, j], c[:, j]
        Gm = _gmm(Aj, Gm).at[:, :, j * nu:(j + 1) * nu].add(Bj)
        e = _gmv(Aj, e) + cj
        E = _gmm(Aj, E)

    # ---- macro dynamics & terminal ----
    A_c, B_c, c_c = E, Gm, e                   # after the j = M-1 advance
    qx_c = jnp.concatenate([qxg, qp.qx[-1:][...]], axis=0)

    # ---- macro u-box: boxes stay boxes, j-major stacking ----
    idxbu_c = tuple(j * nu + int(i) for j in range(M) for i in idxbu)
    ub_lo_c = grp(qp.ub_lo).reshape(G, M * nbu, L)
    ub_hi_c = grp(qp.ub_hi).reshape(G, M * nbu, L)

    def cat(parts, r, width=None):
        if not parts:
            shape = (G, 0, L) if width is None else (G, 0, width, L)
            return jnp.zeros(shape, dtype)
        return jnp.concatenate(parts, axis=1)

    Ch_c = cat(Ch_parts, nHh + nbx, nx)
    Dh_c = cat(Dh_parts, nHh + nbx, nw)
    hh_lo_c = cat(hlo_parts, nHh + nbx)
    hh_hi_c = cat(hhi_parts, nHh + nbx)
    Cs_c = cat(Cs_parts, nS, nx)
    Ds_c = cat(Ds_parts, nS, nw)
    hofs_c = cat(hofs_parts, nS)
    slh_c = cat(slh_parts, nS)
    suh_c = cat(suh_parts, nS)

    tile = (lambda z: jnp.tile(z, (M, 1)) if z.shape[0] else z)

    qp_c = LaneQP(
        A=A_c, B=B_c, c=c_c, dx0=qp.dx0,
        Qc=Qg, QN=qp.QN, Sc=Sg, Rc=Rg, qx=qx_c, qu=qug,
        ub_lo=ub_lo_c, ub_hi=ub_hi_c,
        xb_lo=jnp.zeros((G, 0, L), dtype),
        xb_hi=jnp.zeros((G, 0, L), dtype),
        xmask=jnp.ones((G, 1, 1), dtype),
        Ch=Ch_c, hh_lo=hh_lo_c, hh_hi=hh_hi_c,
        Cs=Cs_c, hofs=hofs_c, slh=slh_c, suh=suh_c,
        zl=tile(qp.zl), Zl=tile(qp.Zl), zu=tile(qp.zu), Zu=tile(qp.Zu),
        lsh=tile(qp.lsh), ush=tile(qp.ush),
        Dh=Dh_c if (nHh + nbx) else None,
        Ds=Ds_c if nS else None,
    )
    aux = CondenseAux(A=A, B=B, c=c, M=M, nu=nu)
    return qp_c, idxbu_c, aux


def expand_solution(aux: CondenseAux, dx_c, du_c):
    """Macro solution -> full-resolution (dx (N+1, nx, L), du (N, nu, L)).

    dx_c: (G+1, nx, L) macro states (group starts + terminal);
    du_c: (G, M*nu, L) stacked group controls (j-major).
    Interior states are reconstructed by the exact linear intra-group
    recursion; group-start states and the terminal state are taken from
    the macro solution (they satisfy the macro equalities to IPM eq_res).
    """
    G, nx, L = aux.A.shape[0], aux.A.shape[2], aux.A.shape[-1]
    M, nu = aux.M, aux.nu
    w = du_c.reshape(G, M, nu, L)
    cur = dx_c[:-1]                            # (G, nx, L)
    stages = [cur]
    for j in range(M - 1):
        cur = _gmv(aux.A[:, j], cur) + _gmv(aux.B[:, j], w[:, j]) \
            + aux.c[:, j]
        stages.append(cur)
    dx_path = jnp.stack(stages, axis=1).reshape(G * M, nx, L)
    dx = jnp.concatenate([dx_path, dx_c[-1:]], axis=0)
    du = w.reshape(G * M, nu, L)
    return dx, du
