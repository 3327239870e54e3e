"""Small-matrix numerical primitives.

Port of ``asdslam_tpu/estimators/linalg.py``: a batched closed-form 3x3
inverse and a Cholesky solve unrolled for a small fixed n (each step an
elementwise op over the batch, no pivoting loop, no host synchronisation),
and the iterative eigen-solvers the RANSAC model fits use in place of
per-hypothesis SVD calls:

- ``null_vector``: smallest right-singular vector of A by inverse power
  iteration on A^T A + eps I (batched LU solves, a library call as in the
  reference);
- ``jacobi_eigh`` / ``svd3``: cyclic Jacobi on small symmetric matrices and
  the 3x3 SVD assembled from it.
"""

from __future__ import annotations

import torch


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-20)


def inv3x3(A, eps: float = 1e-12):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    adj = torch.stack([torch.stack([co00, co01, co02], -1),
                       torch.stack([co10, co11, co12], -1),
                       torch.stack([co20, co21, co22], -1)], -2)
    return adj * inv_det[..., None, None]


def chol_solve_small(A, b, jitter: float = 0.0):
    """Batched SPD solve A x = b for SMALL fixed n (<= ~8), the Cholesky
    factorisation unrolled in Python.  A: [..., n, n] SPD, b: [..., n] ->
    x [..., n]."""
    n = A.shape[-1]
    zero = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j] - sum((L[i][k] * L[j][k] for k in range(j)), start=zero)
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s + jitter, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        y[i] = (b[..., i] - sum((L[i][k] * y[k] for k in range(i)), start=zero)) / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum((L[k][i] * x[k] for k in range(i + 1, n)), start=zero)) / L[i][i]
    return torch.stack(x, -1)


def null_vector(A, iters: int = 12, eps: float = 1e-7):
    """Unit vector x minimizing |A x| for batched A [..., m, n] (m >= n-1).

    Inverse power iteration on (A^T A + eps*tr*I): converges to the
    eigenvector of the smallest eigenvalue.  Deterministic start vector.
    An all-zero A (a RANSAC hypothesis with no rows) gives NaN for that
    batch element, as the reference's LU does, instead of raising.
    """
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    n = A.shape[-1]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    M = AtA + eps * tr * torch.eye(n, dtype=A.dtype, device=A.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(M)

    x = torch.full(A.shape[:-2] + (n,), 1.0 / n ** 0.5, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        x = _normalize(torch.linalg.lu_solve(lu, piv, x[..., None])[..., 0])
    return x


def top_vector(M, iters: int = 50):
    """Dominant eigenvector of symmetric PSD M [..., n, n] by power iteration."""
    n = M.shape[-1]
    # deterministic, slightly asymmetric start to avoid orthogonal stall
    x = torch.linspace(1.0, 1.3, n, dtype=M.dtype, device=M.device).expand(
        M.shape[:-2] + (n,))
    x = _normalize(x)
    for _ in range(iters):
        x = _normalize(torch.einsum("...ij,...j->...i", M, x))
    return x


def jacobi_eigh(S, sweeps: int = 10):
    """Eigendecomposition of batched symmetric n x n (n small, static) via
    cyclic Jacobi.  Returns (w, V): eigenvalues DESCENDING, V columns =
    eigenvectors.  Used for 3x3 (svd3) and 4x4 (Horn quaternion) problems."""
    n = S.shape[-1]
    A = S
    eye = torch.eye(n, dtype=S.dtype, device=S.device).expand(S.shape)
    V = eye.clone()

    def givens(A, V, p, q):
        app = A[..., p, p]
        aqq = A[..., q, q]
        apq = A[..., p, q]
        theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
        c = torch.cos(theta)
        s = torch.sin(theta)
        R = eye.clone()
        R[..., p, p] = c
        R[..., q, q] = c
        R[..., p, q] = s
        R[..., q, p] = -s
        return R.transpose(-1, -2) @ A @ R, V @ R

    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    for _ in range(sweeps):
        for (p, q) in pairs:
            A, V = givens(A, V, p, q)

    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.sort(-w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def eigh3(S, sweeps: int = 10):
    """3x3 symmetric eigendecomposition (descending) — see jacobi_eigh."""
    return jacobi_eigh(S, sweeps)


def svd3(A, sweeps: int = 10):
    """SVD of batched 3x3 matrices: returns (U, s, Vt) with s descending.

    V, s^2 from Jacobi eigh of A^T A; U columns from A v_i with a
    cross-product completion for the smallest direction."""
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    w, V = eigh3(AtA, sweeps)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    Av1 = torch.einsum("...ij,...j->...i", A, V[..., 0])
    Av2 = torch.einsum("...ij,...j->...i", A, V[..., 1])
    u1 = _normalize(Av1)
    u2 = _normalize(Av2 - torch.sum(Av2 * u1, dim=-1, keepdim=True) * u1)
    u3 = torch.linalg.cross(u1, u2)
    Av3 = torch.einsum("...ij,...j->...i", A, V[..., 2])
    sgn = torch.sign(torch.sum(u3 * Av3, dim=-1) + 1e-30)
    u3 = u3 * sgn[..., None]
    U = torch.stack([u1, u2, u3], dim=-1)
    return U, s, V.transpose(-1, -2)
