"""Frustum / visibility test — Frame::isInFrustum over a block of map points
(Frame.cc:160-217).

Port of ``asdslam_tpu/frontend/visibility.py``: project, check image bounds,
depth, the scale-invariance distance range and the viewing angle, and predict
the pyramid level from the distance (MapPoint::PredictScale).
"""

from __future__ import annotations

import torch

from asdslam_torch.geometry import se3


def project_points(
    pose7, K, pos, normal, min_dist, max_dist, valid,
    width: float, height: float,
    scale_factor: float = 1.2, n_levels: int = 8,
    min_view_cos: float = 0.5,
    border: float = 0.0,
    x_min: float = 0.0, y_min: float = 0.0,
):
    """Returns (uv [M, 2], pred_level [M] int32, view_cos [M], visible [M]).

    width/height are the MAX image bounds and x_min/y_min the MIN (for a
    distortion-free camera the defaults give the raw image rectangle)."""
    R, t = se3.pose_unpack(pose7)
    xc = pos @ R.T + t
    z = xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = K[0, 0] * xc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * xc[:, 1] / zs + K[1, 2]
    uv = torch.stack([u, v], dim=1)

    c = -(R.T @ t)
    pc = pos - c
    dist = torch.linalg.norm(pc, dim=1)
    view_cos = torch.sum(pc * normal, dim=1) / torch.clamp(dist, min=1e-9)

    in_img = ((u >= x_min + border) & (u < width - border)
              & (v >= y_min + border) & (v < height - border))
    in_depth = z > 0
    in_range = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    ok_angle = view_cos > min_view_cos

    # PredictScale: level = ceil(log(max_dist / dist) / log(scale_factor))
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    # log(scale_factor) in f32 as the reference computes it; a 0-d CPU
    # tensor acts as a scalar on any device
    log_s = torch.log(torch.tensor(scale_factor, dtype=torch.float32))
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6)) / log_s)
    pred_level = torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)

    visible = valid & in_img & in_depth & in_range & ok_angle
    return uv, pred_level, view_cos, visible
