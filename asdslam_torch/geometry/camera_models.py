"""Extended camera/distortion models (aslam_cv2 parity), batched.

Port of ``asdslam_tpu/geometry/camera_models.py``.  The reference vendors
aslam_cv2 with pinhole + unified-projection cameras and radtan /
equidistant / fisheye distortion models
(src/aslam_cv2/aslam_cv_cameras/src/{camera-pinhole,camera-unified-projection,
distortion-radtan,distortion-equidistant,distortion-fisheye}.cc).  The SLAM
pipeline itself only uses pinhole+radtan (geometry/camera.py); these models
complete the camera library for other rigs:

- Equidistant (Kannala-Brandt): r_d = theta(1 + k1 th^2 + k2 th^4 + k3 th^6
  + k4 th^8), inverted by a fixed number of Newton iterations.
- Fisheye (FOV model, single parameter w): r_d = atan(2 r tan(w/2)) / w.
- Unified projection (Mei, mirror parameter xi): projects through the unit
  sphere; handles > 180-degree FOV rigs.

All functions operate on ``[..., 2]`` normalized coordinates / ``[..., 3]``
camera-frame points, matching geometry/camera.py conventions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _f32(v, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


# --------------------------------------------------------------------------- #
# Equidistant (Kannala-Brandt) distortion
# --------------------------------------------------------------------------- #
class EquidistantDistortion(NamedTuple):
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor

    @staticmethod
    def create(k1=0.0, k2=0.0, k3=0.0, k4=0.0, *, device="cuda"):
        return EquidistantDistortion(*(_f32(v, device) for v in (k1, k2, k3, k4)))


def _theta_d(d: EquidistantDistortion, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (d.k1 + t2 * (d.k2 + t2 * (d.k3 + t2 * d.k4))))


def _safe_scale(cond, num, r, fallback):
    """num / r where ``cond``, else ``fallback`` (r kept off zero)."""
    return torch.where(cond, num / torch.clamp(r, min=1e-12),
                       torch.as_tensor(fallback, dtype=r.dtype, device=r.device))


def equidistant_distort(d: EquidistantDistortion, xn):
    """Normalized pinhole coords -> distorted normalized coords."""
    r = torch.sqrt(torch.sum(xn * xn, dim=-1))
    theta = torch.atan(r)
    return xn * _safe_scale(r > 1e-8, _theta_d(d, theta), r, 1.0)[..., None]


def equidistant_undistort(d: EquidistantDistortion, xd, iters: int = 8):
    """Invert via Newton on theta (fixed iteration count)."""
    rd = torch.sqrt(torch.sum(xd * xd, dim=-1))
    theta = rd
    for _ in range(iters):
        t2 = theta * theta
        f = _theta_d(d, theta) - rd
        fp = (1.0 + t2 * (3.0 * d.k1 + t2 * (5.0 * d.k2 + t2 * (
            7.0 * d.k3 + t2 * 9.0 * d.k4))))
        theta = theta - f / torch.clamp(fp, min=1e-6)
    return xd * _safe_scale(rd > 1e-8, torch.tan(theta), rd, 1.0)[..., None]


# --------------------------------------------------------------------------- #
# Fisheye (FOV) distortion: aslam's single-parameter model
# --------------------------------------------------------------------------- #
class FisheyeDistortion(NamedTuple):
    w: torch.Tensor

    @staticmethod
    def create(w=0.8, *, device="cuda"):
        return FisheyeDistortion(_f32(w, device))


def fisheye_distort(d: FisheyeDistortion, xn):
    r = torch.sqrt(torch.sum(xn * xn, dim=-1))
    tanwhalf = torch.tan(d.w / 2.0)
    rd = torch.atan(2.0 * r * tanwhalf) / d.w
    return xn * _safe_scale(r > 1e-8, rd, r, 2.0 * tanwhalf / d.w)[..., None]


def fisheye_undistort(d: FisheyeDistortion, xd):
    rd = torch.sqrt(torch.sum(xd * xd, dim=-1))
    tanwhalf = torch.tan(d.w / 2.0)
    r = torch.tan(rd * d.w) / (2.0 * tanwhalf)
    return xd * _safe_scale(rd > 1e-8, r, rd, d.w / (2.0 * tanwhalf))[..., None]


# --------------------------------------------------------------------------- #
# Unified projection (Mei) camera
# --------------------------------------------------------------------------- #
class UnifiedCamera(NamedTuple):
    xi: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def create(xi, fx, fy, cx, cy, *, device="cuda"):
        return UnifiedCamera(*(_f32(v, device) for v in (xi, fx, fy, cx, cy)))


def unified_project(cam: UnifiedCamera, xc):
    """Camera-frame points [..., 3] -> pixels [..., 2] through the unit
    sphere: x / (z + xi * |x|)."""
    norm = torch.linalg.norm(xc, dim=-1)
    denom = xc[..., 2] + cam.xi * norm
    denom = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
    u = cam.fx * xc[..., 0] / denom + cam.cx
    v = cam.fy * xc[..., 1] / denom + cam.cy
    return torch.stack([u, v], dim=-1)


def unified_backproject(cam: UnifiedCamera, uv):
    """Pixels -> unit-norm camera-frame ray [..., 3] (inverse of
    unified_project up to scale)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    r2 = mx * mx + my * my
    # solve for z on the unit sphere: aslam's camera-unified-projection.cc
    disc = 1.0 + (1.0 - cam.xi * cam.xi) * r2
    zs = (cam.xi + torch.sqrt(torch.clamp(disc, min=0.0))) / (1.0 + r2)
    ray = torch.stack([zs * mx, zs * my, zs - cam.xi], dim=-1)
    return ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True), min=1e-12)
