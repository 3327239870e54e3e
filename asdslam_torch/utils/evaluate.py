"""Trajectory evaluation: Umeyama sim3 alignment + ATE RMSE.

Copy of ``asdslam_tpu/utils/evaluate.py`` (numpy).

Implements the reference's evaluation protocol (BASELINE.md): sim3 Umeyama
alignment over all matched poses (eval_cfg.yaml `align_type: sim3,
align_num_frames: -1` in experiment_result/*), ATE = RMSE of aligned
translation error, association by nearest timestamp/frame id.
"""

from __future__ import annotations

import numpy as np


def umeyama_sim3(src: np.ndarray, dst: np.ndarray):
    """Least-squares sim3 aligning src -> dst (both [N, 3]).

    Returns (s, R, t) with dst ~ s R src + t (Umeyama 1991)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: str = "sim3"):
    """ATE RMSE after alignment. est/gt: [N, 3] associated positions."""
    if align == "sim3":
        s, R, t = umeyama_sim3(est_positions, gt_positions)
        aligned = (s * (R @ est_positions.T)).T + t
    elif align == "se3":
        s, R, t = umeyama_sim3(est_positions, gt_positions)
        aligned = (R @ est_positions.T).T + t
    else:
        aligned = est_positions
    err = aligned - gt_positions
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def associate_by_id(est, gt):
    """est, gt: dict frame_id -> position. Returns matched [N, 3] arrays."""
    common = sorted(set(est) & set(gt))
    return (np.array([est[i] for i in common]),
            np.array([gt[i] for i in common]))


def drift_analysis(est: np.ndarray, gt: np.ndarray, ids=None,
                   n_curve: int = 120, seg_len: float = 100.0):
    """Localize WHERE trajectory error comes from (diagnosis artifact for the
    accuracy contract): global sim3-aligned error as a function of distance
    travelled, plus per-segment LOCAL sim3 statistics that separate scale
    drift from local tracking noise.

    est, gt: associated [N, 3] camera centres in frame order.
    Returns a JSON-ready dict:
      error_curve    — [{id, arc_m, err_m}] global-alignment error over the run
      segments       — per ~seg_len-metre window: local-sim3 RMSE (tracking
                       noise), local scale relative to the global alignment
                       (scale drift), and the window's global-aligned error
      scale_drift_pct — max |local scale - 1| * 100 over windows
    """
    s, R, t = umeyama_sim3(est, gt)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    d = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(d)])
    idx = np.unique(np.linspace(0, len(err) - 1,
                                min(n_curve, len(err))).astype(int))
    curve = [{"id": int(ids[i]) if ids is not None else int(i),
              "arc_m": round(float(arc[i]), 1),
              "err_m": round(float(err[i]), 2)} for i in idx]

    segments = []
    start = 0
    for i in range(1, len(arc)):
        if arc[i] - arc[start] >= seg_len or (i == len(arc) - 1 and i > start + 5):
            w_est, w_gt = aligned[start:i + 1], gt[start:i + 1]
            if len(w_est) >= 5:
                sl, Rl, tl = umeyama_sim3(w_est, w_gt)
                local = (sl * (Rl @ w_est.T)).T + tl
                rmse_l = float(np.sqrt(((local - w_gt) ** 2).sum(1).mean()))
                segments.append({
                    "arc_m": round(float(arc[start]), 1),
                    "frames": int(i - start + 1),
                    "local_rmse_m": round(rmse_l, 3),
                    "local_scale": round(float(sl), 4),
                    "global_err_m": round(float(err[start:i + 1].mean()), 2),
                })
            start = i
    scale_dev = max((abs(sg["local_scale"] - 1.0) for sg in segments),
                    default=0.0)
    return {"error_curve": curve, "segments": segments,
            "scale_drift_pct": round(100.0 * scale_dev, 2),
            "global_scale": round(float(s), 4)}


def camera_centers(traj):
    """[(frame_id, pose7 T_cw)] -> dict frame_id -> camera centre."""
    from asdslam_torch.mapping.map_store import _pose_np
    out = {}
    for fid, pose7 in traj:
        R, t = _pose_np(np.asarray(pose7))
        out[fid] = -R.T @ t
    return out
