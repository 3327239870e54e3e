"""Image pyramid + Gaussian blur.

Port of ``asdslam_tpu/ops/pyramid.py`` (ORBextractor::ComputePyramid,
ORBextractor.cc:1251-1276): ``n_levels`` levels scaled by 1/scale_factor each
with bilinear resampling, and a 7x7 sigma=2 Gaussian-blurred copy of each
level for the descriptor patches (ORBextractor.cc:1093-1097).

The resize is the reference's ``jax.image.resize(..., "linear")``: a
triangle filter widened by the downscale factor (it antialiases), applied as
one [in, out] weight matrix per axis, built by the same formula.  Its results
differ from the reference's by ~5e-7, the order of the f32 sums; PyTorch's
``F.interpolate(antialias=True)`` differs by ~4e-5, and without ``antialias``
by 0.34.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asdslam_torch.utils.batching import sequential


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for i in range(n_levels):
        s = scale_factor ** i
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device: str) -> torch.Tensor:
    """[n_in, n_out] f32 weights of a linear antialiased resize along one
    axis (``jax.image.scale.compute_weight_mat`` with the triangle kernel,
    scale n_out / n_in, no translation).  Built once per shape."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)
    return torch.from_numpy(w).to(device)


def resize(image: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """[h, w] -> ``shape``, linear with antialiasing when downsampling."""
    h, w = image.shape
    wh = _resize_weights(h, shape[0], str(image.device))
    ww = _resize_weights(w, shape[1], str(image.device))
    return (wh.T @ image) @ ww


# one resize per sequence in the batched tracking step: a matrix product's
# kernel is picked by shape (utils/batching.py)
_resize_each = sequential(resize, "pyramid.resize")


def build_pyramid(image: torch.Tensor, n_levels: int, scale_factor: float):
    """image [H, W] float32 -> list of [h_i, w_i] tensors (level 0 = input),
    each level resized from the previous one (the reference's cascade)."""
    h, w = image.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for i in range(1, n_levels):
        levels.append(_resize_each(levels[-1], shapes[i]))
    return levels


def gaussian_blur(image: torch.Tensor, sigma: float = 2.0, ksize: int = 7):
    """Separable Gaussian blur with edge padding, summed tap by tap in the
    reference's order."""
    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=image.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    H, W = image.shape
    padded = F.pad(image[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = torch.zeros_like(image)
    for i in range(ksize):
        out = out + k[i] * padded[i:i + H]
    padded = F.pad(out[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out2 = torch.zeros_like(image)
    for i in range(ksize):
        out2 = out2 + k[i] * padded[:, i:i + W]
    return out2
