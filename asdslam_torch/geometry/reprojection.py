"""The reprojection residual model of bundle adjustment, shared by the BA
solvers (``backend/ba.py``, ``backend/global_ba.py``, ``parallel/dist.py``)
and motion-only BA's plain LM iteration (``ops/pose_lm.py``): the
observation table, the residuals and their left-multiplicative Jacobians,
and the Huber weight.  Twin of the helpers at the top of the reference's
``asdslam_tpu/backend/ba.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from asdslam_torch.geometry import se3
from asdslam_torch.utils import batching

CHI2_MONO = 5.991


class Obs(NamedTuple):
    """Fixed-capacity observation table for BA.

    cam_idx: [O] int64 index into the camera array
    pt_idx:  [O] int64 index into the point array
    uv:      [O, 2] undistorted pixel observation
    inv_sigma2: [O] information weight (1/sigma^2 of the keypoint level)
    valid:   [O] bool
    """

    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


def project_residuals(poses7, points, obs: Obs, K):
    """Residuals + Jacobians for all observations.

    poses7: [C, 7]; points: [P, 3]; K: [3, 3] intrinsics.
    Returns r [O, 2], Jc [O, 2, 6] (w.r.t. the observing camera's tangent,
    left-mult), Jp [O, 2, 3] (w.r.t. the point), z [O] depths.
    """
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R, t = se3.pose_unpack(poses7[obs.cam_idx])  # [O, 3, 3], [O, 3]
    X = points[obs.pt_idx]
    xc = batching.matmul(R, X[:, :, None])[:, :, 0] + t
    z = xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * xc[:, 0] / zs + cx
    v = fy * xc[:, 1] / zs + cy
    r = torch.stack([u, v], dim=1) - obs.uv

    zi = 1.0 / zs
    zero = torch.zeros_like(zi)
    Jproj = torch.stack(
        [
            torch.stack([fx * zi, zero, -fx * xc[:, 0] * zi * zi], dim=-1),
            torch.stack([zero, fy * zi, -fy * xc[:, 1] * zi * zi], dim=-1),
        ],
        dim=1,
    )  # [O, 2, 3]
    # d(xc)/d(xi): left-mult exp(xi) T => dxc/domega = -[xc]x, dxc/dv = I
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[0], 3, 3)
    Jxi = torch.cat([-se3.hat(xc), eye], dim=2)  # [O, 3, 6]
    return r, batching.matmul(Jproj, Jxi), batching.matmul(Jproj, R), z


def huber_weight(chi2, delta2):
    """IRLS weight for the Huber kernel on chi2 (already sigma-normalized)."""
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = delta2 ** 0.5
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), d / s)
