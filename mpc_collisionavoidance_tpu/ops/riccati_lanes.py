"""Lane-batched Riccati LQR solve (`ops/riccati.py` in the lane layout).

Identical math to :func:`mpc_collisionavoidance_tpu.ops.riccati.lqr_solve`
but every stage tensor carries the instance batch on the minor-most lane
axis: A (N, nx, nx, L), etc.  The backward/forward sweeps are `lax.scan`s
whose bodies are unrolled broadcast FMAs over the tiny state dims —
elementwise over the batch at any batch size.  This is the plain reference
of the Triton sweep kernel (kernels/riccati_pallas.py).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_collisionavoidance_tpu.ops import lanes as ln


class LaneLQR(NamedTuple):
    A: jnp.ndarray    # (N, nx, nx, L)
    B: jnp.ndarray    # (N, nx, nu, L)
    c: jnp.ndarray    # (N, nx, L)
    Q: jnp.ndarray    # (N+1, nx, nx, L)
    S: jnp.ndarray    # (N, nu, nx, L)
    R: jnp.ndarray    # (N, nu, nu, L)
    qx: jnp.ndarray   # (N+1, nx, L)
    qu: jnp.ndarray   # (N, nu, L)
    dx0: jnp.ndarray  # (nx, L)


def lqr_solve_lanes(d: LaneLQR):
    """Returns (dx (N+1, nx, L), du (N, nu, L))."""

    def backward(carry, stage):
        P, p = carry
        A, B, c, Q, S, R, qx, qu = stage
        PA = ln.mm(P, A)                     # (nx, nx, L)
        PB = ln.mm(P, B)                     # (nx, nu, L)
        Pc_p = ln.mv(P, c) + p               # (nx, L)
        Huu = R + ln.mtm(B, PB)              # (nu, nu, L)
        Hux = S + ln.mtm(B, PA)              # (nu, nx, L)
        hu = qu + ln.mtv(B, Pc_p)            # (nu, L)
        Lf = ln.chol_factor(Huu)
        K = -ln.chol_solve_mat(Lf, Hux)      # (nu, nx, L)
        kff = -ln.chol_solve_vec(Lf, hu)     # (nu, L)
        P_new = ln.sym(Q + ln.mtm(A, PA) + ln.mtm(Hux, K))
        p_new = qx + ln.mtv(A, Pc_p) + ln.mtv(Hux, kff)
        return (P_new, p_new), (K, kff)

    init = (d.Q[-1], d.qx[-1])
    stages = (d.A, d.B, d.c, d.Q[:-1], d.S, d.R, d.qx[:-1], d.qu)
    _, (Ks, kffs) = jax.lax.scan(backward, init, stages, reverse=True)

    def forward(dx, stage):
        A, B, c, K, kff = stage
        du = ln.mv(K, dx) + kff
        dx_next = ln.mv(A, dx) + ln.mv(B, du) + c
        return dx_next, (dx, du)

    dx_N, (dxs, dus) = jax.lax.scan(forward, d.dx0, (d.A, d.B, d.c, Ks, kffs))
    dx_all = jnp.concatenate([dxs, dx_N[None]], axis=0)
    return dx_all, dus


def random_lane_lqr(N, nx, nu, L, seed=0, dtype=jnp.float32) -> LaneLQR:
    """A well-posed random stagewise LQR in the lane layout (SPD cost
    blocks, mildly contractive dynamics), made from `seed`: the shared
    input of the Riccati parity checks and sweep benchmarks."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape) * 0.3, dtype)

    Qr = rng.standard_normal((N + 1, nx, nx, L)) * 0.2
    Q = jnp.asarray(np.einsum("nikl,njkl->nijl", Qr, Qr)
                    + 0.5 * np.eye(nx)[None, :, :, None], dtype)
    Rr = rng.standard_normal((N, nu, nu, L)) * 0.2
    R = jnp.asarray(np.einsum("nikl,njkl->nijl", Rr, Rr)
                    + 0.5 * np.eye(nu)[None, :, :, None], dtype)
    A = jnp.asarray(0.9 * np.eye(nx)[None, :, :, None]
                    + 0.05 * rng.standard_normal((N, nx, nx, L)), dtype)
    return LaneLQR(A=A, B=arr(N, nx, nu, L), c=arr(N, nx, L), Q=Q,
                   S=arr(N, nu, nx, L) * 0.1, R=R,
                   qx=arr(N + 1, nx, L), qu=arr(N, nu, L),
                   dx0=arr(nx, L))
