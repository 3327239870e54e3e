"""Batched Sim(3) operations: x -> s R x + t.

Port of ``asdslam_tpu/geometry/sim3.py``.  Used by loop-closure verification
(Horn alignment + Sim3 refinement, replacing src/vslam/src/Sim3Solver.cc +
g2o types_seven_dof_expmap) and the essential-graph pose optimizer
(Optimizer.cc:737-1000).

Packed storage: ``[..., 8] = (qw, qx, qy, qz, tx, ty, tz, log_s)``.
Tangent: ``[..., 7] = (omega[3], upsilon[3], sigma)``.

``sim3_log`` solves its 3x3 system with ``torch.linalg.solve_ex``, a library
call as the reference's ``jnp.linalg.solve`` is, and like it neither raises
on a singular system (the result is inf/NaN) nor waits for the device.
"""

from __future__ import annotations

import torch

from asdslam_torch.geometry import se3

_EPS = 1e-8


def sim3_pack(s, R, t):
    q = se3.matrix_to_quat(R)
    return torch.cat([q, t, torch.log(s)[..., None]], dim=-1)


def sim3_unpack(p):
    return torch.exp(p[..., 7]), se3.quat_to_matrix(p[..., :4]), p[..., 4:7]


def sim3_identity(shape=(), dtype=torch.float32, device="cuda"):
    p = torch.zeros(shape + (8,), dtype=dtype, device=device)
    p[..., 0] = 1.0
    return p


def transform(s, R, t, x):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, x) + t


def compose(sa, Ra, ta, sb, Rb, tb):
    """(a o b)(x) = a(b(x)) = sa Ra (sb Rb x + tb) + ta."""
    return sa * sb, Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta


def inverse(s, R, t):
    si = 1.0 / s
    Rt = R.transpose(-1, -2)
    return si, Rt, -si[..., None] * torch.einsum("...ij,...j->...i", Rt, t)


def _W_coeffs(sigma, theta):
    """Coefficients (A, B, C) of W = A*hat(w) + B*hat(w)^2 + C*I (Sophus-style)."""
    s = torch.exp(sigma)
    theta2 = theta * theta
    sigma2 = sigma * sigma
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta < 1e-5
    one = torch.ones_like(sigma)

    C = torch.where(small_sigma, 1.0 + sigma / 2.0 + sigma2 / 6.0,
                    (s - 1.0) / torch.where(small_sigma, one, sigma))

    # case sigma small:
    A_ss = torch.where(small_theta, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / torch.where(small_theta, one, theta2))
    B_ss = torch.where(small_theta, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta)) / torch.where(small_theta, one, theta2 * theta))

    # case sigma not small:
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sigma2
    safe_sigma = torch.where(small_sigma, one, sigma)
    safe_theta = torch.where(small_theta, one, theta)
    zero = torch.zeros_like(sigma)
    # theta small, sigma not small:
    A_ts = torch.where(small_sigma, zero, ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    B_ts = torch.where(small_sigma, zero,
                       ((0.5 * sigma2 - sigma + 1.0) * s - 1.0) / (safe_sigma ** 3))
    # generic:
    A_gen = (a * sigma + (1.0 - b) * theta) / torch.clamp(safe_theta * c, min=_EPS)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / torch.clamp(c, min=_EPS)) / torch.clamp(
        theta2, min=_EPS)

    A = torch.where(small_sigma, A_ss, torch.where(small_theta, A_ts, A_gen))
    B = torch.where(small_sigma, B_ss, torch.where(small_theta, B_ts, B_gen))
    return A, B, C


def _W_matrix(w, sigma):
    theta = torch.sqrt(torch.sum(w * w, dim=-1) + _EPS * _EPS)
    A, B, C = _W_coeffs(sigma, theta)
    Wh = se3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wh.shape)
    return C[..., None, None] * eye + A[..., None, None] * Wh + B[..., None, None] * (Wh @ Wh)


def sim3_exp(xi):
    """Tangent [..., 7] = (omega, upsilon, sigma) -> (s, R, t)."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = se3.so3_exp(w)
    W = _W_matrix(w, sigma)
    t = torch.einsum("...ij,...j->...i", W, v)
    return torch.exp(sigma), R, t


def sim3_log(s, R, t):
    """Inverse of sim3_exp -> [..., 7]."""
    sigma = torch.log(s)
    w = se3.so3_log(R)
    W = _W_matrix(w, sigma)
    v = torch.linalg.solve_ex(W, t[..., None]).result[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def retract(p, xi):
    """Left-multiplicative update on packed sim3: S <- exp(xi) * S."""
    s, R, t = sim3_unpack(p)
    ds, dR, dt = sim3_exp(xi)
    sn, Rn, tn = compose(ds, dR, dt, s, R, t)
    return sim3_pack(sn, Rn, tn)
