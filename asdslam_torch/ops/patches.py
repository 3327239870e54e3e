"""Keypoint-centred patch gathers: orientation (intensity centroid), the
upright descriptor patches and the rotated ones of the ORB path.

Port of ``asdslam_tpu/ops/patches.py`` (IC_Angle, ORBextractor.cc:80-107,
and the 32x32 crop feeding the descriptor, ORBextractor.cc:1099-1133).
Patches are one batched gather over keypoints; upright patches clamp the
keypoint so every patch stays in bounds (callers mask border keypoints
separately), rotated ones clamp each sample.
"""

from __future__ import annotations

import torch

from asdslam_torch.utils import batching


def _gather_patches(image: torch.Tensor, xy: torch.Tensor, size: int):
    """[K, size, size] patches centred at integer keypoints xy (x, y)."""
    H, W = image.shape
    half = size // 2
    # truncation toward zero, as the reference's astype(int32)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - half, 0, W - size)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - half, 0, H - size)
    r = torch.arange(size, device=image.device)
    rows = (y0[:, None] + r[None, :])[:, :, None]
    cols = (x0[:, None] + r[None, :])[:, None, :]
    return image[rows, cols]


def ic_angle(image: torch.Tensor, xy: torch.Tensor, radius: int = 15):
    """Intensity-centroid orientation over a circular patch: atan2(m01, m10)
    with m10 = sum x*I, m01 = sum y*I.  Returns angles in radians [K]."""
    size = 2 * radius + 1
    patches = _gather_patches(image, xy, size)
    coords = torch.arange(size, dtype=torch.float32, device=image.device) - radius
    yy = coords[:, None]
    xx = coords[None, :]
    w = ((yy * yy + xx * xx) <= (radius * radius)).to(torch.float32)
    m10 = batching.sum(patches * (xx * w), dim=(1, 2))
    m01 = batching.sum(patches * (yy * w), dim=(1, 2))
    return batching.atan2(m01, m10)


def extract_patches(image: torch.Tensor, xy: torch.Tensor, size: int = 32):
    """[K, size, size] intensity patches for the descriptor network (the
    image is already in [0, 1])."""
    return _gather_patches(image, xy, size)


def extract_rotated_patches(image: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor,
                            size: int = 32):
    """Rotation-normalized patches [K, size, size]: a size x size grid
    rotated by each keypoint's angle, sampled bilinearly (the ORB path's
    derotation).  Samples clamp to [0, W - 1.000001] x [0, H - 1.000001], as
    the reference's do, so the +1 neighbour stays inside the image."""
    half = (size - 1) / 2.0
    coords = torch.arange(size, dtype=torch.float32, device=image.device) - half
    gy, gx = torch.meshgrid(coords, coords, indexing="ij")
    ca = batching.cos(angles)[:, None, None]
    sa = batching.sin(angles)[:, None, None]
    sx = ca * gx[None] - sa * gy[None] + xy[:, 0][:, None, None]
    sy = sa * gx[None] + ca * gy[None] + xy[:, 1][:, None, None]
    H, W = image.shape
    sx = torch.clamp(sx, 0.0, W - 1.000001)
    sy = torch.clamp(sy, 0.0, H - 1.000001)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = sx - x0
    wy = sy - y0
    v00 = image[y0, x0]
    v01 = image[y0, x1]
    v10 = image[y1, x0]
    v11 = image[y1, x1]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)
