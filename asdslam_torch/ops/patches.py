"""Keypoint-centred patch gathers: orientation (intensity centroid) and the
upright descriptor patches.

Port of ``ic_angle`` and ``extract_patches`` from
``asdslam_tpu/ops/patches.py`` (IC_Angle, ORBextractor.cc:80-107, and the
32x32 crop feeding the descriptor CNN, ORBextractor.cc:1099-1133).  Patches
are one batched gather over keypoints; keypoints are clamped so every patch
stays in bounds (callers mask border keypoints separately).
"""

from __future__ import annotations

import torch


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
    m10 = torch.sum(patches * (xx * w), dim=(1, 2))
    m01 = torch.sum(patches * (yy * w), dim=(1, 2))
    return torch.atan2(m01, m10)


def extract_patches(image: torch.Tensor, xy: torch.Tensor, size: int = 32):
    """[K, size, size] intensity patches for the descriptor network (the
    image is already in [0, 1])."""
    return _gather_patches(image, xy, size)
