"""Full condensing: eliminate the state trajectory from a stage QP.

The accelerator-native counterpart of acados' FULL_CONDENSING path (the qpOASES
alternative the reference keeps one line away from HPIPM, reference
scripts/usv_guidance_ca1/acados_settings.py:189 — commented
``FULL_CONDENSING_QPOASES``; qpOASES itself is component N4 in SURVEY.md
section 2.1).  Condensing substitutes the dynamics

    dx_{k+1} = A_k dx_k + B_k du_k + c_k,     dx_0 = dx0 (pinned)

into the QP so the only decision variable left is the stacked control
vector w = vec(du) in R^{N*nu}:

    dx = M w + m

with M lower block-triangular (the discrete-time impulse response of the
linearized plant) and m the free response from (dx0, c).  All equality
constraints vanish; the result is a dense inequality-constrained QP whose
Hessian is a single (N*nu, N*nu) matrix — a shape dense GEMM kernels suit.
The propagation of M is a `lax.scan` of (nx,nx)@(nx,N*nu) matmuls, one per
stage, so XLA sees N large fused GEMMs instead of the reference's per-core
BLASFEO panel kernels.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_collisionavoidance_tpu.ops.ipm import QPData


class DenseQP(NamedTuple):
    """Condensed QP:  min 0.5 w'H w + g'w  over w in R^{nz}, subject to

        Ghat w + dg >= 0                          (hard rows, N*nI of them)
        slh <= Chat w + dc <= suh   (soft, slack-relaxed; N*nS rows)

    plus the soft-slack cost/bound data copied per-row from the stage QP.
    Also carries (M, m) so stage trajectories can be reconstructed.
    """

    H: jnp.ndarray      # (nz, nz)
    g: jnp.ndarray      # (nz,)
    Ghat: jnp.ndarray   # (mI, nz) hard rows
    dg: jnp.ndarray     # (mI,)
    Chat: jnp.ndarray   # (mS, nz) soft rows (constraint value = Chat w + dc)
    dc: jnp.ndarray     # (mS,)
    slh: jnp.ndarray    # (mS,)
    suh: jnp.ndarray    # (mS,)
    zl: jnp.ndarray     # (mS,)
    Zl: jnp.ndarray     # (mS,)
    zu: jnp.ndarray     # (mS,)
    Zu: jnp.ndarray     # (mS,)
    lsh: jnp.ndarray    # (mS,)
    ush: jnp.ndarray    # (mS,)
    M: jnp.ndarray      # (N+1, nx, nz) state sensitivity wrt w
    m: jnp.ndarray      # (N+1, nx) free response


def condense(qp: QPData) -> DenseQP:
    """Condense a stage-structured `QPData` into a `DenseQP`."""
    N, nx, nu = qp.B.shape
    nz = N * nu
    dtype = qp.A.dtype

    # ---- state sensitivities: dx = M w + m ----
    # M_{k+1} = A_k M_k + B_k E_k,  E_k w = du_k;  m_{k+1} = A_k m_k + c_k.
    def prop(carry, inp):
        Mk, mk = carry
        Ak, Bk, ck, k = inp
        BE = jax.lax.dynamic_update_slice(
            jnp.zeros((nx, nz), dtype), Bk, (0, k * nu))
        Mn = Ak @ Mk + BE
        mn = Ak @ mk + ck
        return (Mn, mn), (Mn, mn)

    M0 = jnp.zeros((nx, nz), dtype)
    m0 = qp.dx0.astype(dtype)
    ks = jnp.arange(N)
    (_, _), (Mrest, mrest) = jax.lax.scan(
        prop, (M0, m0), (qp.A, qp.B, qp.c, ks))
    M = jnp.concatenate([M0[None], Mrest], axis=0)          # (N+1, nx, nz)
    m = jnp.concatenate([m0[None], mrest], axis=0)          # (N+1, nx)

    Mp, mp = M[:-1], m[:-1]                                  # path stages

    # ---- dense cost ----
    # J = 0.5 dx'Q dx + qx'dx + du'S dx + 0.5 du'R du + qu'du, dx = M w + m.
    QM = jnp.einsum("kxy,kyz->kxz", qp.Q, M)                 # (N+1, nx, nz)
    H = jnp.einsum("kxz,kxw->zw", M, QM)                     # M'QM
    SM = jnp.einsum("kux,kxz->kuz", qp.S, Mp)                # (N, nu, nz)
    ESM = SM.reshape(nz, nz)                                 # rows = du slots
    H = H + ESM + ESM.T
    H = H + _block_diag(qp.R)

    g = jnp.einsum("kxz,kx->z", M, jnp.einsum("kxy,ky->kx", qp.Q, m) + qp.qx)
    g = g + (jnp.einsum("kux,kx->ku", qp.S, mp) + qp.qu).reshape(nz)

    # ---- hard rows:  Gx dx + Gu du - gl >= 0  ->  Ghat w + dg >= 0 ----
    nI = qp.Gx.shape[1]
    GxM = jnp.einsum("krx,kxz->krz", qp.Gx, Mp)              # (N, nI, nz)
    GuE = _block_rows(qp.Gu, nz)                             # (N, nI, nz)
    Ghat = (GxM + GuE).reshape(N * nI, nz)
    dg = (jnp.einsum("krx,kx->kr", qp.Gx, mp) - qp.gl).reshape(N * nI)

    # ---- soft rows: value = hofs + Cx dx = Chat w + dc ----
    nS = qp.Cx.shape[1]
    Chat = jnp.einsum("krx,kxz->krz", qp.Cx, Mp).reshape(N * nS, nz)
    dc = (qp.hofs + jnp.einsum("krx,kx->kr", qp.Cx, mp)).reshape(N * nS)

    tile = lambda v: jnp.broadcast_to(v, (N, nS)).reshape(N * nS)
    return DenseQP(
        H=H, g=g, Ghat=Ghat, dg=dg, Chat=Chat, dc=dc,
        slh=qp.slh.reshape(N * nS), suh=qp.suh.reshape(N * nS),
        zl=tile(qp.zl), Zl=tile(qp.Zl), zu=tile(qp.zu), Zu=tile(qp.Zu),
        lsh=tile(qp.lsh), ush=tile(qp.ush),
        M=M, m=m,
    )


def _block_diag(R: jnp.ndarray) -> jnp.ndarray:
    """(N, nu, nu) -> (N*nu, N*nu) block diagonal, trace-friendly."""
    N, nu, _ = R.shape
    out = jnp.zeros((N, nu, N, nu), R.dtype)
    idx = jnp.arange(N)
    out = out.at[idx, :, idx, :].set(R)
    return out.reshape(N * nu, N * nu)


def _block_rows(Gu: jnp.ndarray, nz: int) -> jnp.ndarray:
    """Place each stage's Gu (N, r, nu) into its du_k column slot of w."""
    N, r, nu = Gu.shape
    out = jnp.zeros((N, r, N, nu), Gu.dtype)
    idx = jnp.arange(N)
    out = out.at[idx, :, idx, :].set(Gu)
    return out.reshape(N, r, nz)


def expand(dense: DenseQP, w: jnp.ndarray, N: int, nu: int):
    """Recover the stage trajectories from the condensed solution."""
    dx = jnp.einsum("kxz,z->kx", dense.M, w) + dense.m
    du = w.reshape(N, nu)
    return dx, du
