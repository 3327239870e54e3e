"""Small-matrix solves written out element by element.

Port of ``inv3x3`` and ``chol_solve_small`` from
``asdslam_tpu/estimators/linalg.py``: batched closed-form 3x3 inverse and a
Cholesky solve unrolled for a small fixed n, each step an elementwise op over
the batch (no pivoting loop, no host synchronisation).
"""

from __future__ import annotations

import torch


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
