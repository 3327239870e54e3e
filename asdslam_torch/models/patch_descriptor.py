"""Deterministic classical patch descriptor (no learned weights).

Port of ``asdslam_tpu/models/patch_descriptor.py``: normalized, downsampled
patch intensities -> 128-d unit vector.  Used for bring-up and tests where
the ASDNet weights are untrained; plugs into the same descriptor_fn slot as
an ``ASDNet``.
"""

from __future__ import annotations

import torch


def apply(patches: torch.Tensor) -> torch.Tensor:
    """patches [N, 32, 32] float -> [N, 128] L2-normalized descriptors.

    Average-pool 32x32 -> 16x8 (2x4 pools), whiten per patch, L2-normalize.
    Rectangular pooling keeps some vertical detail while fitting 128 dims.
    """
    n = patches.shape[0]
    # 32x32 -> 16x8: pool 2 rows x 4 cols
    x = patches.reshape(n, 16, 2, 8, 4).mean(dim=(2, 4))
    x = x.reshape(n, 128)
    x = x - torch.mean(x, dim=1, keepdim=True)
    x = x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-8)
    return x
