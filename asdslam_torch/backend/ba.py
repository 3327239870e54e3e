"""Motion-only bundle adjustment (PoseOptimization parity,
Optimizer.cc:239-413).

Port of ``Obs``, ``_project_residuals``, ``_huber_weight`` and
``pose_only_optimize`` from ``asdslam_tpu/backend/ba.py``: ``rounds`` rounds
of ``iters`` Levenberg-Marquardt steps, Huber sqrt(5.991) in every round but
the last, chi2 outlier gating between rounds on the 2-DoF 95% quantile.

Residual convention: r = project(R_cw X + t_cw) - uv_observed, weighted by
inv_sigma2 of the keypoint's pyramid level.  The pose update is
left-multiplicative (exp(xi) * T), as ``se3.pose_retract``.

The reference runs the LM steps in a ``lax.scan``; here they are a Python
loop whose accept/reject is a ``torch.where`` on device, so the solve never
waits on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from asdslam_torch.estimators.linalg import chol_solve_small
from asdslam_torch.geometry import se3

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


def _project_residuals(poses7, points, obs: Obs, K):
    """Residuals + Jacobians for all observations.

    poses7: [C, 7]; points: [P, 3]; K: [3, 3] intrinsics.
    Returns r [O, 2], Jc [O, 2, 6] (w.r.t. the observing camera's tangent,
    left-mult), Jp [O, 2, 3] (w.r.t. the point), z [O] depths.
    """
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R, t = se3.pose_unpack(poses7[obs.cam_idx])  # [O, 3, 3], [O, 3]
    X = points[obs.pt_idx]
    xc = (R @ X[:, :, None])[:, :, 0] + t
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
    return r, Jproj @ Jxi, Jproj @ R, z


def _huber_weight(chi2, delta2):
    """IRLS weight for the Huber kernel on chi2 (already sigma-normalized)."""
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = delta2 ** 0.5
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), d / s)


def pose_only_optimize(
    pose7, points, uv, inv_sigma2, valid, K,
    rounds: int = 4, iters: int = 10, chi2_th: float = CHI2_MONO,
    huber: bool = True,
):
    """Optimize a single camera pose against fixed 3D points.

    pose7: [7]; points: [N, 3] world; uv: [N, 2]; valid: [N] bool.
    Returns (pose7_opt, inlier_mask [N], n_inliers int32).  Observations with
    chi2 > chi2_th are outliers for the next round and re-enter if their
    error drops below the gate, as in the reference.
    """
    N = points.shape[0]
    dev = points.device
    obs = Obs(
        cam_idx=torch.zeros(N, dtype=torch.int64, device=dev),
        pt_idx=torch.arange(N, device=dev),
        uv=uv, inv_sigma2=inv_sigma2, valid=valid,
    )
    delta2 = CHI2_MONO
    eye6 = torch.eye(6, dtype=pose7.dtype, device=dev)

    def chi2_of(pose):
        r, _, _, z = _project_residuals(pose[None], points, obs, K)
        return torch.sum(r * r, dim=1) * inv_sigma2, z

    def cost_fn(pose, inliers):
        chi2, _ = chi2_of(pose)
        # Huber cost rho(chi2)
        c = torch.where(chi2 <= delta2, chi2,
                        2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
        return torch.sum(torch.where(inliers, c, torch.zeros_like(c)))

    def lm_round(pose, inliers, use_huber):
        lam = torch.tensor(1e-3, dtype=pose.dtype, device=dev)
        cost = cost_fn(pose, inliers)
        for _ in range(iters):
            r, Jc, _, _ = _project_residuals(pose[None], points, obs, K)
            chi2 = torch.sum(r * r, dim=1) * inv_sigma2
            w_h = _huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
            w = inv_sigma2 * w_h * inliers.to(r.dtype)
            H = torch.einsum("oki,o,okj->ij", Jc, w, Jc)
            g = torch.einsum("oki,o,ok->i", Jc, w, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            cand = se3.pose_retract(pose, -chol_solve_small(Hd, g))
            new_cost = cost_fn(cand, inliers)
            accept = new_cost < cost
            pose = torch.where(accept, cand, pose)
            lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e6))
            cost = torch.where(accept, new_cost, cost)
        return pose

    pose = pose7
    inliers = valid
    for rd in range(rounds):
        use_huber = huber and rd < rounds - 1  # last round: plain kernel (g2o parity)
        pose = lm_round(pose, inliers, use_huber)
        chi2, z = chi2_of(pose)
        inliers = valid & (chi2 <= chi2_th) & (z > 0)

    return pose, inliers, torch.sum(inliers, dtype=torch.int32)
