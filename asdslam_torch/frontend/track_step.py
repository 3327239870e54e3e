"""The per-frame tracking step, on the device.

Port of ``asdslam_tpu/frontend/track_step.py``: the reference's per-frame
hot path (Tracking.cc:213-383) — extract -> TrackWithMotionModel (664-723,
with the <20-matches widened retry at 681-685) -> PoseOptimization ->
TrackLocalMap (725-767) -> PoseOptimization — as one function whose state
(pose, velocity, features, matched geometry, candidate-row binding) stays on
the device from frame to frame.

Differences from the reference, none of them in results:

- the widened-radius retry (a ``lax.cond`` there) runs both searches and
  keeps the wide one's result where the narrow one found fewer than
  ``min_motion_matches`` (a ``torch.where`` on the count): the step reads
  nothing back to the host, so a caller can queue the next frame before
  this one's result is fetched;
- each ``.at[...].set(mode="drop")`` is a scatter into a buffer one row
  longer than the output, whose last row takes the dropped writes and is
  sliced off.  Rows that land in the kept part are unique (the matcher has
  resolved duplicates), so no write order can change a result.

Match bookkeeping uses "source codes": for current feature f, src[f] in
[0, N) means "matched to previous-frame feature src[f]", src[f] in
[N, N + P) means "matched to local-map candidate row src[f] - N", and -1
means unmatched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from asdslam_torch.backend import ba
from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend import visibility
from asdslam_torch.geometry import se3
from asdslam_torch.ops import match
from asdslam_torch.utils import graphs


class GeomBlock(NamedTuple):
    """Fixed-capacity block of map-point geometry."""

    pos: torch.Tensor       # [P, 3]
    normal: torch.Tensor    # [P, 3]
    min_dist: torch.Tensor  # [P]
    max_dist: torch.Tensor  # [P]
    valid: torch.Tensor     # [P] bool


class PointBlock(NamedTuple):
    """GeomBlock + descriptors, for the local-map candidate stage."""

    pos: torch.Tensor       # [P, 3]
    normal: torch.Tensor    # [P, 3]
    min_dist: torch.Tensor  # [P]
    max_dist: torch.Tensor  # [P]
    desc: torch.Tensor      # [P, D]
    valid: torch.Tensor     # [P] bool


class TrackResult(NamedTuple):
    pose: torch.Tensor       # [7] optimized T_cw
    velocity: torch.Tensor   # [7] T_cur * T_prev^-1
    src: torch.Tensor        # [N] int32 match source codes (inliers only)
    n_motion: torch.Tensor   # motion-model matches found (after retry), int32
    n_track: torch.Tensor    # pose-opt inliers after the motion stage, int32
    n_inliers: torch.Tensor  # final inliers after the local-map stage, int32
    next_geom: GeomBlock     # per-feature matched map-point geometry: the
    #                          NEXT frame's prev_pts
    crow: torch.Tensor       # [N] int32 candidate-row binding per feature
    #                          (-1 = not a row of the current candidate
    #                          block); fed back as the next call's prev_crow


def _scatter_codes(idx, ok, codes, n_out):
    """out[idx[a]] = codes[a] for ok rows; -1 elsewhere."""
    safe = torch.where(ok, idx, n_out)
    out = torch.full((n_out + 1,), -1, dtype=torch.int32, device=idx.device)
    out[safe] = codes.to(torch.int32)
    return out[:n_out]


def _scatter_rows(base, idx, ok, values):
    """base with base[idx[a]] = values[a] for ok rows (a copy)."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,) + base.shape[1:])], dim=0)
    out[torch.where(ok, idx, n)] = values
    return out[:n]


def make_track_step(cfg: SlamConfig, K, extract_fn, device="cuda"):
    """Build the tracking step.

    extract_fn: image [H, W] float32 -> FrameFeatures (``make_extractor``).
    K: [3, 3] intrinsics.  The step runs on ``device``; its inputs are moved
    there (the image as uint8, the reference's upload).  On a CUDA device the
    step is replayed from a CUDA graph (``utils/graphs.py``, the reference's
    ``jax.jit``), the eager function kept as ``.eager``; on the CPU it is the
    eager function."""
    K = torch.as_tensor(K, dtype=torch.float32).to(device)
    scale_factors = torch.tensor(cfg.scale_factors, dtype=torch.float32, device=device)
    inv_sigma2 = torch.tensor(cfg.inv_level_sigma2, dtype=torch.float32, device=device)
    N = cfg.n_features
    bx0, bx1, by0, by1 = cfg.undistorted_bounds
    use_kernel = cfg.use_pallas_match

    def track_step(img, prev_pose7, velocity7, prev_feat,
                   prev_pts: GeomBlock, cand_pts: PointBlock, prev_crow=None):
        """prev_crow: optional [N] int32, the previous call's ``crow``.
        Candidate rows whose point a previous feature already holds are
        masked out of the local-map search (None = no rows bound)."""
        img = torch.as_tensor(img).to(device)
        if not img.is_floating_point():
            img = img.to(torch.float32) * (1.0 / 255.0)
        feat = extract_fn(img)

        pred = se3.pose_retract(prev_pose7, se3.se3_log(*se3.pose_unpack(velocity7)))

        # ---- motion-model stage (TrackWithMotionModel) ------------------- #
        uv_p, _, _, vis_p = visibility.project_points(
            pred, K, prev_pts.pos, prev_pts.normal,
            prev_pts.min_dist, prev_pts.max_dist, prev_pts.valid,
            bx1, by1, cfg.scale_factor, cfg.n_levels, min_view_cos=-1.0,
            x_min=bx0, y_min=by0)

        lvl_radius = scale_factors[prev_feat.level.to(torch.int64)]

        def run_search(radius):
            return match.search_projection(
                prev_feat.desc, feat.desc, uv_p, feat.uv_und,
                vis_p, feat.valid, radius * lvl_radius, cfg.match_th_high,
                ratio=1.0, pred_level_a=prev_feat.level, levels_b=feat.level,
                use_kernel=use_kernel)

        narrow = run_search(cfg.search_radius_motion)
        wide = run_search(cfg.search_radius_motion_wide)
        use_wide = torch.sum(narrow[2], dtype=torch.int32) < cfg.min_motion_matches
        idx_m, d_m, ok_m = (torch.where(use_wide, w, n) for n, w in zip(narrow, wide))
        if cfg.check_orientation:
            ok_m = match.rotation_consistency(
                prev_feat.angle, feat.angle, idx_m, ok_m,
                histo_length=cfg.histo_length)
        n_motion = torch.sum(ok_m, dtype=torch.int32)

        arange_n = torch.arange(N, device=device)
        src1 = _scatter_codes(idx_m, ok_m, arange_n, N)
        pos_f = _scatter_rows(torch.zeros((N, 3), dtype=torch.float32, device=device),
                              idx_m, ok_m, prev_pts.pos)
        has1 = src1 >= 0

        inv_s2_f = inv_sigma2[feat.level.to(torch.int64)]
        pose1, inl1, n_track = ba.pose_only_optimize(
            pred, pos_f, feat.uv_und, inv_s2_f, has1 & feat.valid, K,
            rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters)
        src1 = torch.where(inl1, src1, -1)

        # ---- local-map stage (TrackLocalMap) ----------------------------- #
        P = cand_pts.pos.shape[0]
        cand_valid = cand_pts.valid
        if prev_crow is not None:
            held = prev_crow >= 0
            rows = torch.where(held, torch.clamp(prev_crow, 0, P - 1).to(torch.int64), P)
            # index_fill_ takes the value as a kernel argument: indexing
            # with a Python scalar would copy it to the device and wait
            bound = torch.zeros(P + 1, dtype=torch.bool, device=device).index_fill_(0, rows, True)
            cand_valid = cand_valid & ~bound[:P]
        uv_c, lvl_c, _, vis_c = visibility.project_points(
            pose1, K, cand_pts.pos, cand_pts.normal,
            cand_pts.min_dist, cand_pts.max_dist, cand_valid,
            bx1, by1, cfg.scale_factor, cfg.n_levels,
            x_min=bx0, y_min=by0)
        radii_c = cfg.search_radius_local * scale_factors[lvl_c.to(torch.int64)]
        idx_c, _, ok_c = match.search_projection(
            cand_pts.desc, feat.desc, uv_c, feat.uv_und,
            vis_c, feat.valid, radii_c, cfg.match_th_high,
            ratio=0.8, pred_level_a=lvl_c, levels_b=feat.level,
            skip_b=src1 >= 0, use_kernel=use_kernel)

        src2 = _scatter_codes(idx_c, ok_c, N + torch.arange(P, device=device), N)
        pos_f = _scatter_rows(pos_f, idx_c, ok_c, cand_pts.pos)
        src = torch.where(src1 >= 0, src1, src2)

        pose2, inl2, n_in = ba.pose_only_optimize(
            pose1, pos_f, feat.uv_und, inv_s2_f, (src >= 0) & feat.valid, K,
            rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters)
        src = torch.where(inl2, src, -1)

        # velocity = T_cur * T_prev^-1 (Tracking.cc's mVelocity update)
        Rv, tv = se3.compose(*se3.pose_unpack(pose2),
                             *se3.inverse(*se3.pose_unpack(prev_pose7)))
        vel = se3.pose_pack(Rv, tv)

        # next frame's prev_pts: matched map-point geometry gathered through
        # the src codes, on the device
        sel_cand = src >= N
        i_prev = torch.clamp(src, 0, N - 1).to(torch.int64)
        i_cand = torch.clamp(src - N, 0, P - 1).to(torch.int64)

        def gather_field(prev_f, cand_f):
            m = sel_cand.reshape((-1,) + (1,) * (prev_f.ndim - 1))
            return torch.where(m, cand_f[i_cand], prev_f[i_prev])

        next_geom = GeomBlock(
            pos=gather_field(prev_pts.pos, cand_pts.pos),
            normal=gather_field(prev_pts.normal, cand_pts.normal),
            min_dist=gather_field(prev_pts.min_dist, cand_pts.min_dist),
            max_dist=gather_field(prev_pts.max_dist, cand_pts.max_dist),
            valid=src >= 0)

        # candidate-row binding: features matched to a cand row take that
        # row; features matched to a previous feature inherit its row
        if prev_crow is None:
            inherited = torch.full((N,), -1, dtype=torch.int32, device=device)
        else:
            inherited = prev_crow[i_prev]
        crow = torch.where(src >= N, src - N,
                           torch.where(src >= 0, inherited, -1)).to(torch.int32)

        res = TrackResult(pose=pose2, velocity=vel, src=src,
                          n_motion=n_motion, n_track=n_track, n_inliers=n_in,
                          next_geom=next_geom, crow=crow)
        return feat, res

    if torch.device(device).type != "cuda":
        return track_step
    graph_step = graphs.captured(track_step, "track_step")

    def captured_step(img, prev_pose7, velocity7, prev_feat, prev_pts, cand_pts,
                      prev_crow=None):
        """``track_step`` replayed from a CUDA graph: the image is uploaded
        first (a graph takes device tensors), and a missing ``prev_crow`` is
        all -1 (no row bound: the same result), so both give one graph."""
        if prev_crow is None:
            prev_crow = torch.full((N,), -1, dtype=torch.int32, device=device)
        return graph_step(torch.as_tensor(img).to(device), prev_pose7, velocity7, prev_feat,
                          prev_pts, cand_pts, prev_crow)

    captured_step.eager = track_step
    captured_step.graphs = graph_step
    return captured_step
