"""Lane-batched small-matrix algebra.

The OCP stage matrices are tiny (nx <= 14, nu <= 2); batching thousands of
instances is where the throughput lives.  A batched `dot_general` on
(B, 8, 8) operands puts the tiny 8x8 dims on the minor axes, where vector
units and matrix units are mostly idle.

The lane layout used here instead keeps the INSTANCE axis minor-most —
tensors are (m, n, L) with L = batch on the minor (lane) dimension — and
expresses every small matmul as an unrolled broadcast-multiply-reduce over
the tiny dims, so each FMA is one elementwise op over L lanes, coalesced
in memory.

All helpers below follow that convention; loops over tiny static dims are
Python-level and unroll at trace time.
"""

import jax.numpy as jnp


def mm(A, B):
    """(m,k,L) @ (k,n,L) -> (m,n,L)."""
    return jnp.sum(A[:, :, None, :] * B[None, :, :, :], axis=1)


def mtm(A, B):
    """A^T @ B: (k,m,L),(k,n,L) -> (m,n,L)."""
    return jnp.sum(A[:, :, None, :] * B[:, None, :, :], axis=0)


def mmt(A, B):
    """A @ B^T: (m,k,L),(n,k,L) -> (m,n,L)."""
    return jnp.sum(A[:, None, :, :] * B[None, :, :, :], axis=2)


def mv(A, x):
    """(m,k,L) @ (k,L) -> (m,L)."""
    return jnp.sum(A * x[None, :, :], axis=1)


def mtv(A, x):
    """A^T @ x: (k,m,L),(k,L) -> (m,L)."""
    return jnp.sum(A * x[:, None, :], axis=0)


def transpose(A):
    """(m,n,L) -> (n,m,L)."""
    return jnp.swapaxes(A, 0, 1)


def sym(A):
    return 0.5 * (A + transpose(A))


def gram_rows(C, w, out_dim):
    """sum_r w[r] * C[r] C[r]^T over constraint rows.

    C: (r, m, L) row vectors, w: (r, L) weights -> (m, m, L).
    Unrolled over r (static, <= 8) to keep intermediates at (m, m, L).
    """
    r = C.shape[0]
    acc = jnp.zeros((out_dim, out_dim, C.shape[-1]), C.dtype)
    for i in range(r):
        ci = C[i]                       # (m, L)
        acc = acc + (w[i] * ci)[:, None, :] * ci[None, :, :]
    return acc


def rows_tv(C, v):
    """sum_r v[r] * C[r]: (r, m, L), (r, L) -> (m, L)  (i.e. C^T v)."""
    return jnp.sum(C * v[:, None, :], axis=0)


def rows_mv(C, x):
    """row values: (r, m, L), (m, L) -> (r, L)  (i.e. C x per row)."""
    return jnp.sum(C * x[None, :, :], axis=1)


def chol_factor(H):
    """Unrolled Cholesky of a tiny SPD matrix batch: H (n, n, L) -> list-of-
    lists lower factor with (L,) entries."""
    n = H.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[i, j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return L


def chol_solve_vec(Lf, b):
    """Solve (L L^T) x = b for b (n, L_lanes)."""
    n = len(Lf)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for t in range(i):
            s = s - Lf[i][t] * y[t]
        y[i] = s / Lf[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for t in range(i + 1, n):
            s = s - Lf[t][i] * x[t]
        x[i] = s / Lf[i][i]
    return jnp.stack(x)


def chol_solve_mat(Lf, Bm):
    """Solve (L L^T) X = B for B (n, k, L_lanes) -> (n, k, L_lanes)."""
    n = len(Lf)
    k = Bm.shape[1]
    cols = [chol_solve_vec(Lf, Bm[:, j, :]) for j in range(k)]
    return jnp.stack(cols, axis=1)


# ---- stage-batched variants: leading N stage axis, trailing L lane axis ----

def smv(A, x):
    """(N,m,k,L) @ (N,k,L) -> (N,m,L)."""
    return jnp.sum(A * x[:, None, :, :], axis=2)


def smtv(A, x):
    """A^T x stagewise: (N,k,m,L),(N,k,L) -> (N,m,L)."""
    return jnp.sum(A * x[:, :, None, :], axis=1)


def srows_mv(C, x):
    """Row values stagewise: (N,r,m,L),(N,m,L) -> (N,r,L)."""
    return jnp.sum(C * x[:, None, :, :], axis=2)


def srows_tv(C, v):
    """C^T v stagewise: (N,r,m,L),(N,r,L) -> (N,m,L)."""
    return jnp.sum(C * v[:, :, None, :], axis=1)


def sgram_rows(C, w):
    """sum_r w[.,r] C[.,r] C[.,r]^T stagewise: (N,r,m,L),(N,r,L) -> (N,m,m,L).

    Unrolled over the (static, small) row count r so intermediates stay at
    (N, m, m, L)."""
    N, r, m, L = C.shape
    acc = jnp.zeros((N, m, m, L), C.dtype)
    for i in range(r):
        ci = C[:, i]                                  # (N, m, L)
        acc = acc + (w[:, i][:, None, :] * ci)[:, :, None, :] * ci[:, None, :, :]
    return acc


def sgram_cross(D, C, w):
    """sum_r w[.,r] D[.,r] C[.,r]^T stagewise: (N,r,m,L),(N,r,n,L),(N,r,L)
    -> (N,m,n,L).  The cross term of constraint-row grams when rows couple
    two variable blocks (e.g. partially condensed rows C dx + D du)."""
    N, r, m, L = D.shape
    n = C.shape[2]
    acc = jnp.zeros((N, m, n, L), D.dtype)
    for i in range(r):
        di = D[:, i]                                  # (N, m, L)
        ci = C[:, i]                                  # (N, n, L)
        acc = acc + (w[:, i][:, None, :] * di)[:, :, None, :] * ci[:, None, :, :]
    return acc


def ge_solve_mat(M, B):
    """Solve M X = B for general (non-symmetric) tiny M: (n, n, L) x
    (n, k, L) -> (n, k, L).

    Unrolled Gaussian elimination WITHOUT pivoting — callers must pass
    well-conditioned systems (the parallel-Riccati resolvents I + C J with
    C, J PSD have spectrum in [1, inf), so this is safe there).
    """
    n, k = M.shape[0], B.shape[1]
    # working copies as python lists of (L,) rows
    a = [[M[i, j] for j in range(n)] for i in range(n)]
    b = [[B[i, j] for j in range(k)] for i in range(n)]
    for col in range(n):
        piv = a[col][col]
        inv = 1.0 / piv
        for j in range(col + 1, n):
            a[col][j] = a[col][j] * inv
        for j in range(k):
            b[col][j] = b[col][j] * inv
        for row in range(n):
            if row == col:
                continue
            f = a[row][col]
            for j in range(col + 1, n):
                a[row][j] = a[row][j] - f * a[col][j]
            for j in range(k):
                b[row][j] = b[row][j] - f * b[col][j]
    return jnp.stack([jnp.stack(b[i], axis=0) for i in range(n)], axis=0)
