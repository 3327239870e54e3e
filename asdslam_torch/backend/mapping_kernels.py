"""Local-mapping device functions: a keyframe against all its covisible
neighbours.

Port of ``asdslam_tpu/backend/mapping_kernels.py``.  CreateNewMapPoints
matches/triangulates against up to 20 covisible KFs
(src/vslam/src/LocalMapping.cc:299-556) and SearchInNeighbors fuses with 10
neighbours in both directions (557-656).  The reference evaluates the padded
neighbour axis in one program and fetches all verdicts at once; here the
neighbours are a Python loop over the LIVE slots, every launch queued before
the caller's single fetch, and padded slots (whose validity is all false and
whose result is all -1) are filled on the host without a launch.

``fuse_pairs`` calls ``match.search_projection``, which on a CUDA tensor is
the hand-written masked-NN kernel: one launch per live pair.

The reference packs its verdicts as int16 to spare download bytes; these
return int64, the values are the same.
"""

from __future__ import annotations

import torch

from asdslam_torch.frontend import visibility
from asdslam_torch.geometry import triangulation
from asdslam_torch.ops import match


def triangulate_neighbors(
    f1_desc, f1_uv, f1_level, f1_free,
    nb_desc, nb_uv, nb_level, nb_free,
    nb_R, nb_t, R1, t1, K, inv_sigma2_lut,
    max_dist: float, ratio: float, fmean: float,
    min_parallax_cos: float = 0.9998,
):
    """Epipolar search + midpoint triangulation of KF1 against its neighbour
    KFs (CreateNewMapPoints, LocalMapping.cc:299-556).

    f1_*: [N, ...] current keyframe features (free = valid & unmatched).
    nb_*: sequences of Q per-neighbour tensors [N, ...]; nb_free [Q, N];
    nb_R/nb_t: [Q, 3, 3]/[Q, 3].
    Returns (enc [Q, N] int64, X [Q, N, 3]): per f1 feature per neighbour
    the matched neighbour feature where the triangulation passed every
    check, else -1; and the triangulated world point.
    """
    Kinv = torch.linalg.inv(K)
    xn1 = (triangulation.homog(f1_uv) @ Kinv.T)[:, :2]
    c1 = -(R1.T @ t1)
    lvl1 = f1_level.to(torch.int64)
    s2_1 = 1.0 / inv_sigma2_lut[lvl1]
    th1 = 5.991 * s2_1 / (fmean * fmean)

    encs, Xs = [], []
    for q in range(len(nb_desc)):
        desc2, uv2, R2, t2 = nb_desc[q], nb_uv[q], nb_R[q], nb_t[q]
        F12 = match.fundamental_from_poses(K, R1, t1, R2, t2)
        inv_s2_2 = inv_sigma2_lut[nb_level[q].to(torch.int64)]
        idx, d, ok = match.search_triangulation(
            f1_desc, desc2, f1_uv, uv2, f1_free, nb_free[q], F12, inv_s2_2,
            max_dist=max_dist, ratio=ratio)
        xn2 = (triangulation.homog(uv2[idx]) @ Kinv.T)[:, :2]
        X = triangulation.triangulate_midpoint(R1, t1, R2, t2, xn1, xn2)
        e1, z1 = triangulation.reprojection_error2(R1, t1, X, xn1)
        e2, z2 = triangulation.reprojection_error2(R2, t2, X, xn2)
        c2 = -(R2.T @ t2)
        cosp = triangulation.parallax_cos(c1, c2, X)
        s2_2 = 1.0 / inv_s2_2[idx]
        th2 = 5.991 * s2_2 / (fmean * fmean)
        good = (ok & (z1 > 0) & (z2 > 0) & (e1 < th1) & (e2 < th2)
                & (cosp < min_parallax_cos))
        encs.append(torch.where(good, idx, -1))
        Xs.append(X)
    return torch.stack(encs), torch.stack(Xs)


def fuse_pairs(
    mp_pos, mp_normal, mp_mind, mp_maxd, mp_desc, mp_valid,
    dst_pose7, dst_desc, dst_uv, dst_level, dst_valid,
    K, scale_factors, width: float, height: float,
    scale_factor: float, n_levels: int, fuse_radius: float, max_dist: float,
    n_live=None, use_kernel: bool = True,
):
    """Projection fuse of map-point blocks into destination keyframes
    (SearchInNeighbors, LocalMapping.cc:557-656).

    mp_*: [Q, P, ...] per-pair source map-point blocks.  mp_desc may arrive
    bf16 (halved upload bytes; values re-widened here so all math but the
    matcher's dot stays f32: the rounding is far below the match
    thresholds).  dst_*: sequences of per-pair destination keyframe features
    [N, ...]; dst_pose7 [Q, 7].  n_live: the first ``n_live`` pairs are real
    (default: all); the rest are padding with ``mp_valid`` all false.
    Returns enc [Q, P] int64: the matched destination feature, or -1.
    """
    mp_desc = mp_desc.to(torch.float32)
    Q, P = mp_valid.shape
    n_live = Q if n_live is None else n_live
    enc = torch.full((Q, P), -1, dtype=torch.int64, device=mp_valid.device)
    for q in range(n_live):
        uv, pred_level, _, vis = visibility.project_points(
            dst_pose7[q], K, mp_pos[q], mp_normal[q], mp_mind[q], mp_maxd[q],
            mp_valid[q], width, height, scale_factor, n_levels)
        radii = fuse_radius * scale_factors[pred_level.to(torch.int64)]
        idx, d, ok = match.search_projection(
            mp_desc[q], dst_desc[q], uv, dst_uv[q], vis, dst_valid[q], radii, max_dist,
            ratio=1.0, pred_level_a=pred_level, levels_b=dst_level[q],
            use_kernel=use_kernel)
        enc[q] = torch.where(ok, idx, -1)
    return enc
