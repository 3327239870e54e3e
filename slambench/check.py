"""The comparisons that decide ``correct``.

Three numbers, and a fourth where the configuration's file names it, each
against a limit that the file states (``limits``), each worked out by the
plain references of ``reference.py`` from the benchmark's own inputs, and
each judging what the timed path produced:

- ``ate_share``: the window's poses against the generator's ground truth:
  the RMS error of the tracked camera centres after the least-squares
  similarity onto the true ones, as a share of the true path's length over
  those frames.
- ``desc_gap``: the descriptor network and the extraction in front of it:
  the largest distance between a keyframe's stored descriptor and the
  reference's descriptor of the same keypoint, over the valid features of
  keyframes inserted in the window (a sample of them drawn from the seed).
- ``k1_gap``: K1's masked top-2, over every row of each launch the window
  ran (the last replay of each recorded launch): the largest of the
  program's pick above the reference's best distance, and of the gaps of
  its best and second distances to the reference's.  A row whose gating
  disagrees with the reference's, or whose pick is gated out, reads inf.
- ``loop_gap`` (only where ``limits`` names it): the closure that the loop
  correction left at the loop's two ends: for each loop closed in the
  window, the closure error of its lap in the keyframes' poses after
  ``finish()`` after a similarity fit onto the truth, as a share of the
  lap's length; inf where no loop closed in the window.  It does not judge
  how the correction is spread over the lap's interior (the essential
  graph, global BA).  Every keyframe the run made counts, culled ones
  too, each at the pose the map holds for it: a culled keyframe keeps its
  spanning-tree parent, so every essential-graph optimisation after its
  cull moves it with the graph, while local and global BA move only the
  keyframes that still observe points.  The frames' trajectory is not
  judged, neither the live one (a correction moves keyframes after the
  fact) nor the recomposed one (each frame keeps its offset from its
  reference keyframe in the scale of its time, so a correction that
  rescales the keyframes leaves the frames off by a share of that offset),
  and the valid keyframes alone would not do: by the window's end the map
  has culled most keyframes of the first lap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import reference as ref

BIG_HALF = 0.5 * ref.BIG


def ate_share(est_pose7: np.ndarray, gt_pose7: np.ndarray) -> float:
    """Sim3-aligned ATE over the path length, both of [F, 7] T_cw poses of
    the same frames; inf for fewer than three frames."""
    if len(est_pose7) < 3:
        return math.inf
    est, gt = ref.centres(est_pose7), ref.centres(gt_pose7)
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return ref.sim3_ate(est, gt) / length if length > 0 else math.inf


def loop_gap(loops, trajectory, truth_pose7: np.ndarray) -> float:
    """``reference.loop_gap`` of the window's loops [(f0, f1)] on a
    trajectory [(frame, T_cw pose7)] (the keyframes' poses, or the frames')
    against the true poses of every frame of the stream ([F, 7] T_cw)."""
    frames = [int(f) for f, _ in trajectory]
    est = (dict(zip(frames, ref.centres(np.stack([p for _, p in trajectory]))))
           if frames else {})
    return ref.loop_gap(loops, est, ref.centres(truth_pose7))


def desc_gap(samples, weights: dict, slam: dict, device, dtype="f32", program=True):
    """The largest L2 distance between the judged descriptors and the
    reference's.  ``samples``: [(image uint8, uv, level, desc, valid)] of
    keyframes.  ``program=False`` judges the reference computed in
    ``dtype`` in the program's place (the control) instead of the stored
    descriptors."""
    worst = 0.0
    for image, uv, level, desc, valid in samples:
        sel = np.flatnonzero(valid)
        if not len(sel):
            continue
        pat = ref.patches_at(image, uv[sel], level[sel], slam["n_levels"],
                             slam["scale_factor"], device)
        want = ref.describe(pat, weights, "f32")
        got = (torch.from_numpy(desc[sel]).to(device) if program
               else ref.describe(pat, weights, dtype))
        worst = max(worst, float(torch.linalg.norm(got - want, dim=1).max()))
    return worst


def k1_gap(launches, device, judged=None) -> float:
    """The largest gap of the judged top-2 to the reference's over every
    row of ``launches`` ([(nine inputs, level window, (idx, best, second))]
    as CPU tensors).  ``judged(args, window)`` replaces the program's
    outputs (the control)."""
    worst = 0.0
    for args, window, outs in launches:
        desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, lev_a, lev_b = (
            t.to(device) for t in args)
        ok = ref.gate(valid_a, valid_b, uv_a, uv_b, rad2, lev_a, lev_b, window)
        dist = ref.distances(desc_a, desc_b)
        _, best_r, _ = ref.top2(dist, ok)
        idx, best, second = (judged((desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, lev_a,
                                     lev_b), window) if judged is not None else outs)
        idx, best, second = (idx.to(device).long(), best.to(device).double(),
                             second.to(device).double())
        live_r = best_r < BIG_HALF
        live = best < BIG_HALF
        if bool((live != live_r).any()):
            return math.inf
        rows = torch.nonzero(live)[:, 0]
        if not len(rows):
            continue
        pick = idx[rows]
        if bool((pick < 0).any() or (pick >= dist.shape[1]).any()):
            return math.inf
        if not bool(ok[rows, pick].all()):
            return math.inf
        d_pick = dist[rows, pick]
        others = torch.where(ok[rows], dist[rows], torch.full_like(dist[rows], ref.BIG))
        others[torch.arange(len(rows), device=device), pick] = ref.BIG
        second_r = others.amin(1)
        s_live, s_live_r = second[rows] < BIG_HALF, second_r < BIG_HALF
        if bool((s_live != s_live_r).any()):
            return math.inf
        gaps = [d_pick - best_r[rows], (best[rows] - d_pick).abs()]
        if bool(s_live.any()):
            gaps.append((second[rows][s_live] - second_r[s_live]).abs())
        worst = max(worst, max(float(g.max()) for g in gaps))
    return worst


def k1_control(args, window):
    """K1's top-2 computed by the reference with the dot's operands in
    float8 (the control)."""
    desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, lev_a, lev_b = args
    ok = ref.gate(valid_a, valid_b, uv_a, uv_b, rad2, lev_a, lev_b, window)
    idx, best, second = ref.top2(ref.distances(desc_a, desc_b, "fp8"), ok)
    return idx, best, second
