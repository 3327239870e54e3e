"""Batched SE(3) / SO(3) operations on torch tensors.

Port of ``asdslam_tpu/geometry/se3.py``; the same conventions:

- rotations as unit quaternions ``[..., 4]`` in (w, x, y, z) order, or
  matrices ``[..., 3, 3]``;
- a camera pose is T_cw (world -> camera): ``x_c = R x_w + t``;
- poses stored as ``[..., 7] = (qw, qx, qy, qz, tx, ty, tz)``;
- tangent vectors ``[..., 6] = (omega, upsilon)`` with rotation first.

All functions broadcast over leading batch dimensions and branch on no data:
small-angle cases are selected with ``torch.where`` and Taylor fallbacks, so
the functions never synchronise with the device.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


# --------------------------------------------------------------------------- #
# Quaternions
# --------------------------------------------------------------------------- #
def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q, v):
    """Rotate vectors ``v[..., 3]`` by quaternions ``q[..., 4]``."""
    qv = q[..., 1:]
    w = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_to_matrix(q):
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix ``[..., 3, 3]`` -> quaternion (w,x,y,z), Shepperd-style.

    Computes all four candidate constructions and selects the numerically
    best by the largest diagonal-based magnitude."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)  # first occurrence, as jnp.argmax
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4cand, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)  # canonical sign: w >= 0
    return quat_normalize(q)


# --------------------------------------------------------------------------- #
# SO(3) exp / log
# --------------------------------------------------------------------------- #
def hat(w):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _rodrigues_coeffs(theta2):
    """(sin t / t, (1 - cos t) / t^2, theta) with Taylor fallbacks."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return a, b, small


def so3_exp(w):
    """Rodrigues: tangent [..., 3] -> rotation matrix [..., 3, 3]."""
    a, b, _ = _rodrigues_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation matrix [..., 3, 3] -> tangent [..., 3]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_t = torch.sin(theta)  # theta in [0, pi] so sin_t >= 0
    small = sin_t < 1e-6
    near_pi = small & (cos_t < 0)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * sin_t, min=_EPS))
    w_generic = w * scale[..., None]
    # Near pi: axis_i = sqrt((R_ii + 1) / 2), signs from the off-diagonals of
    # the largest axis.
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    k = torch.argmax(axis_abs, dim=-1)

    def sign_of(i, j):
        return torch.sign(R[..., i, j] + R[..., j, i] + _EPS)

    s01, s02, s12 = sign_of(0, 1), sign_of(0, 2), sign_of(1, 2)
    a0, a1, a2 = axis_abs.unbind(-1)
    ax0 = torch.stack([a0, s01 * a1, s02 * a2], dim=-1)
    ax1 = torch.stack([s01 * a0, a1, s12 * a2], dim=-1)
    ax2 = torch.stack([s02 * a0, s12 * a1, a2], dim=-1)
    axes = torch.stack([ax0, ax1, ax2], dim=-2)
    idx = k[..., None, None].expand(k.shape + (1, 3))
    axis = torch.gather(axes, -2, idx)[..., 0, :]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


# --------------------------------------------------------------------------- #
# SE(3)
# --------------------------------------------------------------------------- #
def se3_exp(xi):
    """Tangent [..., 6] = (omega, upsilon) -> (R [...,3,3], t [...,3])."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    a, b, small = _rodrigues_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    W = hat(w)
    WW = W @ W
    I = _eye_like(W)
    R = I + a[..., None, None] * W + b[..., None, None] * WW
    V = I + b[..., None, None] * W + c[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """Inverse of se3_exp -> [..., 6]."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    a, b, small = _rodrigues_coeffs(theta2)
    W = hat(w)
    WW = W @ W
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / torch.clamp(theta2, min=_EPS),
    )
    Vinv = _eye_like(W) - 0.5 * W + coef[..., None, None] * WW
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, x):
    """Apply pose to points ``x[..., 3]``."""
    return (R @ x[..., None])[..., 0] + t


# --------------------------------------------------------------------------- #
# Packed [7] pose <-> (R, t)
# --------------------------------------------------------------------------- #
def pose_pack(R, t):
    return torch.cat([matrix_to_quat(R), t], dim=-1)


def pose_unpack(p):
    return quat_to_matrix(p[..., :4]), p[..., 4:]


def pose_identity(shape=(), dtype=torch.float32, device="cuda"):
    p = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    p[..., 0] = 1.0
    return p


def pose_retract(p, xi):
    """Left-multiplicative update: T <- exp(xi) * T  (g2o SE3 convention)."""
    R, t = pose_unpack(p)
    dR, dt = se3_exp(xi)
    Rn, tn = compose(dR, dt, R, t)
    return pose_pack(Rn, tn)
