"""Stage-wise Riccati factorization/solve as `lax.scan`.

This is the accelerator-native replacement for HPIPM's Riccati-recursion KKT solver
(reference solver option PARTIAL_CONDENSING_HPIPM, reference
scripts/usv_guidance_ca1/acados_settings.py:190): each interior-point
iteration reduces to one equality-constrained LQR solve

    min  sum_k 0.5 w_k' H_k w_k + g_k' w_k      (w_k = (dx_k, du_k))
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 = dx0,

which we solve with a backward gain recursion and a forward rollout, both
expressed as `lax.scan` over the horizon so XLA compiles a single fused loop.
Batching over scenario instances is done by `jax.vmap` outside — the scan
body then operates on (B, nx, nx) tensors and XLA maps the small matmuls
onto batched kernels.

Dimensions are tiny (nx <= 14), so per-stage cost is dominated by memory
movement; the design keeps every per-stage tensor within one fused scan
iteration.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LQRData(NamedTuple):
    """Equality-constrained time-varying LQR problem (affine residual form)."""

    A: jnp.ndarray    # (N, nx, nx)
    B: jnp.ndarray    # (N, nx, nu)
    c: jnp.ndarray    # (N, nx)  dynamics residual
    Q: jnp.ndarray    # (N+1, nx, nx)  (terminal in last slot)
    S: jnp.ndarray    # (N, nu, nx)  cross term d2/du dx
    R: jnp.ndarray    # (N, nu, nu)
    qx: jnp.ndarray   # (N+1, nx)
    qu: jnp.ndarray   # (N, nu)
    dx0: jnp.ndarray  # (nx,)


def lqr_solve(d: LQRData, reg: float = 0.0):
    """Solve the LQR problem; returns (dx (N+1,nx), du (N,nu)).

    `reg` adds Levenberg regularization to the control Hessian before the
    factorization (0 for parity with HPIPM on well-posed problems).
    """
    nu = d.B.shape[-1]
    eye_u = jnp.eye(nu, dtype=d.B.dtype)

    def backward(carry, stage):
        P, p = carry
        A, B, c, Q, S, R, qx, qu = stage
        PA = P @ A                        # (nx, nx)
        PB = P @ B                        # (nx, nu)
        Pc_p = P @ c + p                  # (nx,)
        Huu = R + B.T @ PB + reg * eye_u  # (nu, nu)
        Hux = S + B.T @ PA                # (nu, nx)
        hu = qu + B.T @ Pc_p              # (nu,)
        # Factor the (tiny) control Hessian once for both gain and ff term.
        L = jnp.linalg.cholesky(Huu)
        K = -jax.scipy.linalg.cho_solve((L, True), Hux)   # (nu, nx)
        kff = -jax.scipy.linalg.cho_solve((L, True), hu)  # (nu,)
        P_new = Q + A.T @ PA + Hux.T @ K
        P_new = 0.5 * (P_new + P_new.T)
        p_new = qx + A.T @ Pc_p + Hux.T @ kff
        return (P_new, p_new), (K, kff)

    init = (d.Q[-1], d.qx[-1])
    stages = (d.A, d.B, d.c, d.Q[:-1], d.S, d.R, d.qx[:-1], d.qu)
    _, (Ks, kffs) = jax.lax.scan(backward, init, stages, reverse=True)

    def forward(dx, stage):
        A, B, c, K, kff = stage
        du = K @ dx + kff
        dx_next = A @ dx + B @ du + c
        return dx_next, (dx, du)

    dx_N, (dxs, dus) = jax.lax.scan(forward, d.dx0, (d.A, d.B, d.c, Ks, kffs))
    dx_all = jnp.concatenate([dxs, dx_N[None]], axis=0)
    return dx_all, dus
