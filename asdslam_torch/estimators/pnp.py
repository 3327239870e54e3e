"""PnP relocalization: batched-hypothesis RANSAC + DLT pose solve.

Port of ``asdslam_tpu/estimators/pnp.py`` (the role of PnPsolver.cc: EPnP +
RANSAC, params p=0.99 / minInliers=10 / 300 iters / th2=5.991 from
Tracking.cc:1141).  The minimal solve is a 6-point DLT of the projection
matrix (12-dim inverse-power null vector, batched over all hypotheses at
once, no early-exit loop), with the rotation re-orthogonalized via svd3.
Accuracy is recovered by the inlier refit + the caller's pose_only_optimize
polish, matching the reference's PnPsolver -> PoseOptimization pipeline.

As in ``twoview.initialize_two_view`` the RANSAC draws are an argument: the
uniform matrix ``g`` [iters, N] the reference draws inside from its key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from asdslam_torch.estimators import linalg
from asdslam_torch.estimators.twoview import first_argmax, pick, sample_rows
from asdslam_torch.geometry.triangulation import homog


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _dlt_rows(X, xn):
    """DLT rows for P [3, 4]: X [S, M, 3] world, xn [S, M, 2] normalized."""
    Xh = homog(X)  # [S, M, 4]
    z = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    r1 = torch.cat([Xh, z, -u * Xh], dim=-1)   # [S, M, 12]
    r2 = torch.cat([z, Xh, -v * Xh], dim=-1)
    return torch.cat([r1, r2], dim=-2)  # [S, 2M, 12]


def _pose_from_P(P):
    """P [S, 3, 4] -> (R [S, 3, 3], t [S, 3]) with orthogonal R, det +1."""
    A = P[..., :3]
    U, s, Vt = linalg.svd3(A)
    R = U @ Vt
    det = torch.linalg.det(R)
    # flip to proper rotation
    flip = torch.where(det < 0, -1.0, 1.0)[..., None, None]
    R = R * flip
    scale = (torch.mean(s, dim=-1) * flip[..., 0, 0])[..., None]
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, torch.full_like(scale, 1e-12), scale)
    # cheirality is resolved later by the inlier count (both signs scored)
    return R, t


def ransac_pnp(g, X, uv, valid, K, chi2_px, min_inliers: int = 10, sample_size: int = 6):
    """g [iters, N] uniform draws; X [N, 3] world points, uv [N, 2] pixels,
    chi2_px [N] per-point squared pixel gates (5.991 * sigma2 of the octave).
    Returns PnPResult."""
    iters = g.shape[0]
    Kinv = torch.linalg.inv_ex(K).inverse
    xn = (homog(uv) @ Kinv.T)[:, :2]

    samples = sample_rows(g, valid, sample_size)

    A = _dlt_rows(X[samples], xn[samples])
    p = linalg.null_vector(A)
    R, t = _pose_from_P(p.reshape(iters, 3, 4))

    def score(R, t):
        # both translation signs of every hypothesis
        Rs = torch.cat([R, R], dim=0)
        ts = torch.cat([t, -t], dim=0)
        xc = torch.einsum("sij,nj->sni", Rs, X) + ts[:, None, :]
        z = xc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = K[0, 0] * xc[..., 0] / zs + K[0, 2]
        v = K[1, 1] * xc[..., 1] / zs + K[1, 2]
        e = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
        inl = (e < chi2_px[None, :]) & (z > 0) & valid[None, :]
        counts = torch.sum(inl, dim=1)
        i = first_argmax(counts)
        return pick(Rs, i), pick(ts, i), pick(inl, i), pick(counts, i)

    R_b, t_b, inl_b, n_b = score(R, t)

    # refit on inliers of the best hypothesis (the reference weights row 2i
    # and 2i+1 of the [u-rows; v-rows] stack by inlier i: kept as it is)
    A_all = (_dlt_rows(X[None], xn[None])[0]
             * torch.repeat_interleave(inl_b, 2)[:, None].to(X.dtype))
    p_r = linalg.null_vector(A_all[None])[0]
    R_r, t_r, inl_r, n_r = score(*_pose_from_P(p_r.reshape(1, 3, 4)))
    use_refit = n_r >= n_b
    R_f = torch.where(use_refit, R_r, R_b)
    t_f = torch.where(use_refit, t_r, t_b)
    inl_f = torch.where(use_refit, inl_r, inl_b)
    n = torch.sum(inl_f)
    return PnPResult(success=n >= min_inliers, R=R_f, t=t_f,
                     inliers=inl_f, n_inliers=n)
