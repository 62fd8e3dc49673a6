"""Fused Riccati LQR sweep as one Pallas kernel for NVIDIA GPUs (Triton).

Drop-in replacement for `ops.riccati_lanes.lqr_solve_lanes`: the same
backward Riccati factor/solve and forward rollout, but the whole recursion
over the N stages runs inside ONE kernel program per group of lanes.

Why: the `lax.scan` version is a chain of 2N dependent scan steps per call
(N = 100 at the flagship), each of them several small XLA kernels over
(nx, nx, L) operands, so the per-step launch and loop overhead dwarfs the
~100 FLOPs per lane per stage.  Here the stage loops are `fori_loop`s
INSIDE the kernel.

Work split and storage:

- one program owns LANE_BLOCK = 32 lanes, one lane per thread of one
  warp; programs run in parallel on the SMs and share nothing.  On an
  H100 one warp per program beat 64 and 128 lanes at L = 512 and 4096
  (more programs, more SMs busy);
- the tiny state dimensions are unrolled at trace time (the idiom of
  `ops/lanes.py`): P, p and the per-stage temporaries are Python lists of
  (LANE_BLOCK,) vectors, i.e. registers.  Only the upper triangle of the
  symmetric P is carried (nx(nx+1)/2 vectors instead of nx^2);
- each stage's A[s, i, j], B, Q, ... is loaded as one lane vector,
  coalesced because lanes are minor-most.  Stage and state dims are indexed
  with scalars, so no dimension needs power-of-two padding;
- the two nx^3 products of a stage run as loops over one state index
  (columns of P A, then rank-1 updates of A^T (P A)), with P A staged in a
  per-lane scratch output.  Each loop body is O(nx^2) code, and the stage
  loop carries P's triangle and p: nx(nx+3)/2 values per lane;
- the feedback gains K/kff go to an output that the forward sweep reads
  back (the Triton route has no scratch memory, so scratch is outputs).

Compile time grows steeply with nx, as the carried triangle does (measured
on an H100: ~15 s at nx = 8, 6 min 25 s at nx = 14).  A variant with P in
scratch and O(nx) loop bodies compiled in 43 s at nx = 14, but its sweep
was slower than the plain `lax` sweep's there and 2.7x slower than this
kernel's at nx = 8.  So the production preset (`riccati="auto"`) runs this
kernel up to `KERNEL_MAX_NX` and the `lax` sweep above it.

Interpret mode (`interpret=True`) runs the same kernel on the CPU; it is
reachable only through this wrapper's argument, for tests.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

#: lanes per program: one warp, one lane per thread (module doc)
LANE_BLOCK = 32
#: widest state the production preset runs this kernel at (module doc)
KERNEL_MAX_NX = 8


def pad_lanes(x, target_l):
    """Pad the minor-most (lane) axis to `target_l` in edge mode.

    Edge replication (not zeros) keeps padded lanes numerically
    well-conditioned — a zero-padded QP has singular R blocks whose
    Cholesky produces NaN lanes; replicating the last real lane gives the
    padding the same central path as a real instance.  All kernel math is
    lanewise, so padded lanes never contaminate real ones; the wrapper
    slices them off before returning."""
    L = x.shape[-1]
    if L == target_l:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, target_l - L)]
    return jnp.pad(x, pad, mode="edge")


def _sum(terms):
    """Left-to-right sum of a non-empty sequence of lane vectors (no
    zero start term, so nothing is added that the compiler must fold)."""
    terms = iter(terms)
    acc = next(terms)
    for t in terms:
        acc = acc + t
    return acc


def _chol(H, nu):
    """Unrolled Cholesky factor of a tiny SPD matrix (nested lists of lane
    vectors; nu <= 2 in the model zoo)."""
    Lf = [[None] * nu for _ in range(nu)]
    for a in range(nu):
        for b in range(a + 1):
            acc = H[a][b]
            for t in range(b):
                acc = acc - Lf[a][t] * Lf[b][t]
            Lf[a][b] = jnp.sqrt(acc) if a == b else acc / Lf[b][b]
    return Lf


def _chol_solve(Lf, rhs):
    """Solve (L L^T) x = rhs for a list of lane vectors."""
    nu = len(Lf)
    y = [None] * nu
    for a in range(nu):
        acc = rhs[a]
        for t in range(a):
            acc = acc - Lf[a][t] * y[t]
        y[a] = acc / Lf[a][a]
    x = [None] * nu
    for a in reversed(range(nu)):
        acc = y[a]
        for t in range(a + 1, nu):
            acc = acc - Lf[t][a] * x[t]
        x[a] = acc / Lf[a][a]
    return x


def _kernel(A, B, c, Q, S, R, qx, qu, dx0, dx_out, du_out, K_out, k_out,
            PA_s, Hux_s, Pc_s, *, N, nx, nu):
    """One lane group: full backward + forward sweep.

    Every ref is 2-D, (rows, lanes): the wrapper flattens the stage and
    state dims into rows (row-major), so one load is one row index plus
    the lane slice.  Row layout per stage s:
      A (N*nx*nx)  [s, i, j]   B (N*nx*nu)  [s, i, a]   c (N*nx)  [s, i]
      Q ((N+1)*nx*nx)          S (N*nu*nx)  [s, a, j]   R (N*nu*nu)
      qx ((N+1)*nx)  qu (N*nu)  dx0 (nx)
    Outputs: dx_out ((N+1)*nx), du_out (N*nu), the gains K_out (N*nu*nx)
    and k_out (N*nu) handed to the forward sweep, and per-stage scratch
    PA_s (nx*nx) = P A, Hux_s (nu*nx), Pc_s (nx) = P c + p.
    """
    tri = [(i, j) for i in range(nx) for j in range(i, nx)]
    nxx, nxu, nux, nuu = nx * nx, nx * nu, nu * nx, nu * nu

    def backward(i, carry):
        Pt, p = carry
        s = N - 1 - i
        oA, oB, oc, ou = s * nxx, s * nxu, s * nx, s * nu
        oS, oR, oK = s * nux, s * nuu, s * nux
        P = [[None] * nx for _ in range(nx)]    # symmetric view of Pt
        for (r, q), v in zip(tri, Pt):
            P[r][q] = P[q][r] = v

        Bs = [[B[oB + r * nu + a, :] for a in range(nu)] for r in range(nx)]
        cs = [c[oc + r, :] for r in range(nx)]
        PB = [[_sum(P[r][k] * Bs[k][a] for k in range(nx))
               for a in range(nu)] for r in range(nx)]
        Pc_p = [_sum(P[r][k] * cs[k] for k in range(nx)) + p[r]
                for r in range(nx)]
        for r in range(nx):
            Pc_s[r, :] = Pc_p[r]
        Huu = [[R[oR + a * nu + b, :]
                + _sum(Bs[k][a] * PB[k][b] for k in range(nx))
                for b in range(nu)] for a in range(nu)]
        hu = [qu[ou + a, :] + _sum(Bs[k][a] * Pc_p[k] for k in range(nx))
              for a in range(nu)]
        Lf = _chol(Huu, nu)
        kff = _chol_solve(Lf, [-h for h in hu])
        for a in range(nu):
            k_out[ou + a, :] = kff[a]

        def gain_column(q, carry):
            # column q of P A, of Hux = S + B^T P A, and of K = -Huu^-1 Hux
            Aq = [A[oA + k * nx + q, :] for k in range(nx)]
            PAq = [_sum(P[r][k] * Aq[k] for k in range(nx))
                   for r in range(nx)]
            Huxq = [S[oS + a * nx + q, :]
                    + _sum(Bs[k][a] * PAq[k] for k in range(nx))
                    for a in range(nu)]
            Kq = _chol_solve(Lf, [-h for h in Huxq])
            for r in range(nx):
                PA_s[r * nx + q, :] = PAq[r]
            for a in range(nu):
                Hux_s[a * nx + q, :] = Huxq[a]
                K_out[oK + a * nx + q, :] = Kq[a]
            return carry

        jax.lax.fori_loop(0, nx, gain_column, 0)

        def cost_row(k, carry):
            # rank-1 updates by row k of A: P_new += A_k^T (P A)_k and
            # p_new += A_k^T (P c + p)_k
            Pn, pn = carry
            Ak = [A[oA + k * nx + r, :] for r in range(nx)]
            PAk = [PA_s[k * nx + q, :] for q in range(nx)]
            Pc_k = Pc_s[k, :]
            return ([v + Ak[r] * PAk[q] for (r, q), v in zip(tri, Pn)],
                    [v + Ak[r] * Pc_k for r, v in enumerate(pn)])

        Hux = [[Hux_s[a * nx + r, :] for r in range(nx)] for a in range(nu)]
        K = [[K_out[oK + a * nx + r, :] for r in range(nx)]
             for a in range(nu)]
        Pn0 = [Q[oA + r * nx + q, :]
               + _sum(Hux[a][r] * K[a][q] for a in range(nu))
               for r, q in tri]
        pn0 = [qx[oc + r, :] + _sum(Hux[a][r] * kff[a] for a in range(nu))
               for r in range(nx)]
        return jax.lax.fori_loop(0, nx, cost_row, (Pn0, pn0))

    init = ([Q[N * nxx + i * nx + j, :] for i, j in tri],
            [qx[N * nx + r, :] for r in range(nx)])
    jax.lax.fori_loop(0, N, backward, init)

    dx_init = [dx0[r, :] for r in range(nx)]
    for r in range(nx):
        dx_out[r, :] = dx_init[r]

    def forward(s, dx):
        oA, oB, oc, ou, oK = s * nxx, s * nxu, s * nx, s * nu, s * nux
        du = [_sum(K_out[oK + a * nx + q, :] * dx[q] for q in range(nx))
              + k_out[ou + a, :] for a in range(nu)]
        for a in range(nu):
            du_out[ou + a, :] = du[a]

        def a_column(q, acc):
            # acc += A[:, q] * dx[q], dx[q] read back from dx_out
            dxq = dx_out[oc + q, :]
            return [v + A[oA + r * nx + q, :] * dxq
                    for r, v in enumerate(acc)]

        acc0 = [c[oc + r, :] + _sum(B[oB + r * nu + a, :] * du[a]
                                    for a in range(nu))
                for r in range(nx)]
        dxn = jax.lax.fori_loop(0, nx, a_column, acc0)
        for r in range(nx):
            dx_out[oc + nx + r, :] = dxn[r]
        return dxn

    jax.lax.fori_loop(0, N, forward, dx_init)


@functools.partial(jax.jit, static_argnames=("interpret",))
def lqr_solve_lanes_pallas(d, interpret: bool = False):
    """Kernel equivalent of `ops.riccati_lanes.lqr_solve_lanes`.

    `d` is an `ops.riccati_lanes.LaneLQR`.  ANY lane count L >= 1 is
    accepted: lanes are padded (edge mode) to a multiple of LANE_BLOCK and
    sliced back, so the single-vehicle B=1 path runs the same kernel as
    fleet batches.  Returns (dx (N+1, nx, L),
    du (N, nu, L)).
    """
    N, nx, nu, L = d.B.shape[0], d.A.shape[1], d.B.shape[2], d.B.shape[-1]
    blk = LANE_BLOCK
    Lp = -(-L // blk) * blk
    if Lp != L:
        d = jax.tree.map(lambda x: pad_lanes(x, Lp), d)
    dtype = d.A.dtype
    # (lead..., L) -> (rows, L): a free reshape, lanes stay minor-most
    rows = jax.tree.map(lambda x: x.reshape(-1, Lp), d)

    def block(x):
        return pl.BlockSpec((x.shape[0], blk), lambda i: (0, i))

    out_rows = [(N + 1) * nx,      # dx
                N * nu,            # du
                N * nu * nx,       # K (forward-sweep gains)
                N * nu,            # kff
                nx * nx,           # P A of the current stage (scratch)
                nu * nx,           # Hux of the current stage (scratch)
                nx]                # P c + p of the current stage (scratch)
    inputs = (rows.A, rows.B, rows.c, rows.Q, rows.S, rows.R, rows.qx,
              rows.qu, rows.dx0)
    kernel = functools.partial(_kernel, N=N, nx=nx, nu=nu)
    dx, du, *_ = pl.pallas_call(
        kernel,
        grid=(Lp // blk,),
        in_specs=[block(x) for x in inputs],
        out_specs=[pl.BlockSpec((n, blk), lambda i: (0, i))
                   for n in out_rows],
        out_shape=[jax.ShapeDtypeStruct((n, Lp), dtype) for n in out_rows],
        compiler_params=pltriton.CompilerParams(
            num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="riccati_sweep",
    )(*inputs)
    dx = dx.reshape(N + 1, nx, Lp)
    du = du.reshape(N, nu, Lp)
    if Lp != L:
        dx, du = dx[..., :L], du[..., :L]
    return dx, du
