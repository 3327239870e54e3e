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

With ``stamps=True`` the step runs under a stage clock
(``utils/tracing.py``) and its result carries the device's time at each
boundary of ``STAGES``; ``stage_spans`` turns them into the Tracer's
``device/step`` spans.  The stamps add nine one-thread kernels and change no
other value.

Match bookkeeping uses "source codes": for current feature f, src[f] in
[0, N) means "matched to previous-frame feature src[f]", src[f] in
[N, N + P) means "matched to local-map candidate row src[f] - N", and -1
means unmatched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from asdslam_torch.backend import ba
from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend import visibility
from asdslam_torch.geometry import se3
from asdslam_torch.ops import match
from asdslam_torch.utils import batching, graphs, tracing

# the step's stage boundaries, in order: its start, the patches cut
# (extractor), the descriptors masked (extractor), the features ready (after
# any undistortion), the motion searches done, the first pose-only BA done,
# the local-map search done, the second pose-only BA done, its end
STAGES = ("start", "patches", "described", "features", "motion_search", "pose_ba1",
          "local_search", "pose_ba2", "end")


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
    stamps: Optional[torch.Tensor] = None  # [9] int64 ns at each of STAGES
    #                          with stamps on, else None


def stage_spans(stamps):
    """{Tracer span: seconds} of one step's stamps (ns, in ``STAGES``
    order): the whole step, and the four stages that the per-layer metrics
    read; the features' remainder (undistortion) and the final gathers lie
    in ``device/step`` alone."""
    t = dict(zip(STAGES, (int(x) for x in stamps)))

    def ns(a, b):
        return t[b] - t[a]

    return {"device/step": ns("start", "end") * 1e-9,
            "device/step/detect": ns("start", "patches") * 1e-9,
            "device/step/describe": ns("patches", "described") * 1e-9,
            "device/step/search": (ns("features", "motion_search")
                                   + ns("pose_ba1", "local_search")) * 1e-9,
            "device/step/pose_ba": (ns("motion_search", "pose_ba1")
                                    + ns("local_search", "pose_ba2")) * 1e-9}


def _scatter_codes(idx, ok, codes, n_out):
    """out[idx[a]] = codes[a] for ok rows; -1 elsewhere.  Out of place, so
    that it runs under ``torch.func.vmap`` (a batched write into a fresh
    unbatched buffer is refused there)."""
    safe = torch.where(ok, idx, n_out)
    out = torch.full((n_out + 1,), -1, dtype=torch.int32, device=idx.device)
    return out.index_put((safe,), codes.to(torch.int32))[:n_out]


def _scatter_rows(base, idx, ok, values):
    """base with base[idx[a]] = values[a] for ok rows (a copy, out of place
    as ``_scatter_codes``)."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,) + base.shape[1:])], dim=0)
    return out.index_put((torch.where(ok, idx, n),), values)[:n]


def make_track_step(cfg: SlamConfig, K, extract_fn, device="cuda"):
    """Build the tracking step.

    extract_fn: image [H, W] float32 -> FrameFeatures (``make_extractor``).
    K: [3, 3] intrinsics.  The step runs on ``device``; its inputs are moved
    there (the image as uint8, the reference's upload).  On a CUDA device the
    step is replayed from a CUDA graph (``utils/graphs.py``, the reference's
    ``jax.jit``), the eager function kept as ``.eager``; on the CPU it is the
    eager function.  ``stamps=True`` in a call stamps ``STAGES`` (a graph of
    its own on the card)."""
    track_step = _eager_step(cfg, K, extract_fn, device)
    if torch.device(device).type != "cuda":
        return track_step
    return _on_graphs(track_step, "track_step", (cfg.n_features,), device)


def make_batched_track_step(cfg: SlamConfig, K, extract_fn, device="cuda"):
    """The tracking step over a batch of sequences: the reference's
    ``jax.vmap(step)`` (parallel/multi_seq.py), as ``torch.func.vmap`` of
    the same eager step.

    Every argument and result gains a leading sequence axis B (imgs [B, H,
    W], poses [B, 7], ..., prev_crow [B, N] or None).  Each elementwise
    kernel of the step runs once for the B sequences, and each of its three
    masked-NN searches is one batched launch of the kernel
    (``ops/masked_nn.py``'s vmap rule); what a batch could round otherwise
    (small matrix products, float sums, the descriptor network, the
    pyramid's resizes; ``utils/batching.py``) runs once per sequence.
    Sequence b's results are the single step's on sequence b's inputs, bit
    for bit.  On a CUDA device it is replayed from one CUDA graph per B
    (``.eager``: the vmapped function); on the CPU it is the vmapped
    function."""
    track_step = _eager_step(cfg, K, extract_fn, device)

    def unstamped(*a):
        feat, res = track_step(*a)
        return feat, res[:-1]  # a vmap returns no None: the stamps' field

    vmapped = torch.func.vmap(unstamped)
    unbound = torch.func.vmap(lambda *a: unstamped(*a, None))

    def batched_step(imgs, poses, velocities, prev_feats, prev_pts, cand_pts,
                     prev_crow=None):
        # what a batch could round otherwise runs once per sequence
        with batching.per_sequence():
            if prev_crow is None:
                feat, res = unbound(imgs, poses, velocities, prev_feats, prev_pts, cand_pts)
            else:
                feat, res = vmapped(imgs, poses, velocities, prev_feats, prev_pts, cand_pts,
                                    prev_crow)
        return feat, TrackResult(*res)

    if torch.device(device).type != "cuda":
        return batched_step
    return _on_graphs(batched_step, "track_step_batched", (cfg.n_features,), device)


def _on_graphs(step, name, crow_shape, device):
    """``step`` replayed from CUDA graphs (``graphs.captured``): the image is
    uploaded first (a graph takes device tensors), and a missing
    ``prev_crow`` is all -1 (no row bound: the same result), so both give
    one graph.  Keyword arguments (the single step's ``stamps``) pass on as
    constant leaves of the key.  ``.eager`` is ``step``, ``.graphs`` the
    captured callable."""
    graph_step = graphs.captured(step, name)

    def captured_step(img, prev_pose7, velocity7, prev_feat, prev_pts, cand_pts,
                      prev_crow=None, **kw):
        if prev_crow is None:
            lead = tuple(prev_pose7.shape[:-1])  # the batch axis of a batched step
            prev_crow = torch.full(lead + crow_shape, -1, dtype=torch.int32, device=device)
        return graph_step(torch.as_tensor(img).to(device), prev_pose7, velocity7, prev_feat,
                          prev_pts, cand_pts, prev_crow, **kw)

    captured_step.eager = step
    captured_step.graphs = graph_step
    return captured_step


def _eager_step(cfg: SlamConfig, K, extract_fn, device):
    """The tracking step as one eager function of one sequence's inputs
    (``make_track_step``'s docstring)."""
    K = torch.as_tensor(K, dtype=torch.float32).to(device)
    scale_factors = torch.tensor(cfg.scale_factors, dtype=torch.float32, device=device)
    inv_sigma2 = torch.tensor(cfg.inv_level_sigma2, dtype=torch.float32, device=device)
    N = cfg.n_features
    bx0, bx1, by0, by1 = cfg.undistorted_bounds
    use_kernel = cfg.use_pallas_match

    def track_step(img, prev_pose7, velocity7, prev_feat,
                   prev_pts: GeomBlock, cand_pts: PointBlock, prev_crow=None,
                   stamps: bool = False):
        """prev_crow: optional [N] int32, the previous call's ``crow``.
        Candidate rows whose point a previous feature already holds are
        masked out of the local-map search (None = no rows bound).
        stamps: time ``STAGES`` on the device (``TrackResult.stamps``)."""
        if not stamps:
            return step(img, prev_pose7, velocity7, prev_feat, prev_pts, cand_pts, prev_crow)
        with tracing.stage_clock(STAGES, device) as clock:
            feat, res = step(img, prev_pose7, velocity7, prev_feat, prev_pts, cand_pts,
                             prev_crow)
        return feat, res._replace(stamps=clock.stamps)

    def step(img, prev_pose7, velocity7, prev_feat, prev_pts, cand_pts, prev_crow):
        tracing.stage("start")
        img = torch.as_tensor(img).to(device)
        if not img.is_floating_point():
            img = img.to(torch.float32) * (1.0 / 255.0)
        feat = extract_fn(img)
        tracing.stage("features")

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
        tracing.stage("motion_search")

        inv_s2_f = inv_sigma2[feat.level.to(torch.int64)]
        pose1, inl1, n_track = ba.pose_only_optimize(
            pred, pos_f, feat.uv_und, inv_s2_f, has1 & feat.valid, K,
            rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters)
        src1 = torch.where(inl1, src1, -1)
        tracing.stage("pose_ba1")

        # ---- local-map stage (TrackLocalMap) ----------------------------- #
        P = cand_pts.pos.shape[0]
        cand_valid = cand_pts.valid
        if prev_crow is not None:
            held = prev_crow >= 0
            rows = torch.where(held, torch.clamp(prev_crow, 0, P - 1).to(torch.int64), P)
            # index_fill takes the value as a kernel argument: indexing
            # with a Python scalar would copy it to the device and wait
            bound = torch.zeros(P + 1, dtype=torch.bool, device=device).index_fill(0, rows, True)
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
        tracing.stage("local_search")

        pose2, inl2, n_in = ba.pose_only_optimize(
            pose1, pos_f, feat.uv_und, inv_s2_f, (src >= 0) & feat.valid, K,
            rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters)
        src = torch.where(inl2, src, -1)
        tracing.stage("pose_ba2")

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
        tracing.stage("end")
        return feat, res

    return track_step
