"""ORB-style binary descriptor as a float embedding.

Port of ``asdslam_tpu/ops/orb.py`` (the reference's --use_orb path, classic
256-bit ORB, ORBextractor.cc:111-150 computeOrbDescriptor).  The sampling
pattern is the same generated table (256 Gaussian BRIEF pairs from numpy's
``RandomState(42)``), rotation invariance comes from patches sampled
pre-rotated by the keypoint angle (``patches.extract_rotated_patches``), and
each bit is embedded as +-1/16, so the squared L2 distance of two
descriptors is 4 * hamming / 256 and the float matchers (and the masked-NN
kernel at d = 256) serve both descriptor families.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

ORB_DIM = 256
_PATTERN_SEED = 42


def _make_pattern(patch_size: int = 32):
    """256 Gaussian test pairs within the patch (sigma = patch/5, clipped)."""
    rng = np.random.RandomState(_PATTERN_SEED)
    half = patch_size // 2
    sigma = patch_size / 5.0
    lim = half - 3
    pts = np.clip(rng.randn(ORB_DIM, 2, 2) * sigma, -lim, lim)
    return np.round(pts + half).astype(np.int32)  # [256, 2(pair), 2(yx)]


_PATTERN = _make_pattern()


@functools.lru_cache(maxsize=None)
def _pattern_on(device: torch.device):
    """The pattern's (ya, xa, yb, xb) index vectors on ``device``."""
    pat = torch.as_tensor(_PATTERN, dtype=torch.int64, device=device)
    return pat[:, 0, 0], pat[:, 0, 1], pat[:, 1, 0], pat[:, 1, 1]


def apply(patches: torch.Tensor) -> torch.Tensor:
    """patches [N, 32, 32] (already rotation-normalized) -> [N, 256] floats
    in {-1, +1}/16, unit L2 norm."""
    ya, xa, yb, xb = _pattern_on(patches.device)
    bits = (patches[:, ya, xa] < patches[:, yb, xb]).to(torch.float32)
    return (2.0 * bits - 1.0) / 16.0  # 16 = sqrt(ORB_DIM)


def pack_bits(desc) -> np.ndarray:
    """Float embedding (a tensor or an array) -> packed uint8 [N, 32]."""
    if isinstance(desc, torch.Tensor):
        desc = desc.detach().cpu().numpy()
    return np.packbits(np.asarray(desc) > 0, axis=1)
