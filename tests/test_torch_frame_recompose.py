"""The port's reference-protocol frame-trajectory recomposition: the twins
of tests/test_frame_recompose.py, in the same configuration (SlamConfig's
defaults: pipelined tracking and the asynchronous mapping worker).

Each frame's pose is stored relative to its reference keyframe and
recomposed at save time, so later corrections of the keyframes repair the
whole frame trajectory (System::SaveTrajectoryTUM, System.cc:482-541; Tcr
pushed per frame at Tracking.cc:371-375; spanning-tree walk for culled
keyframes at 523-528).
"""

import os
import sys

import numpy as np
import torch

from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend.tracking import _apply_delta_host, _kf_rt, _np_mat_to_quat
from asdslam_torch.models import patch_descriptor
from asdslam_torch.system import System
from asdslam_torch.utils import evaluate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mapping import render_u8  # noqa: E402


def small_config(**kw):
    return SlamConfig(
        n_features=600, n_levels=4, image_width=320, image_height=240,
        fx=260.0, fy=260.0, cx=160.0, cy=120.0, min_match_count=60,
        local_ba_max_points=2048, local_ba_max_obs=8192,
        max_keyframes=64, max_map_points=16384, **kw)


def _mk_system():
    return System(small_config(), descriptor_fn=patch_descriptor.apply, device="cpu")


def test_correction_propagates_to_frames():
    """Moving the ref KF's pose after the fact moves the recomposed frame
    pose with it, preserving the stored relative transform (1e-5)."""
    sys_ = _mk_system()
    s = sys_.store
    feat = sys_.extract(torch.zeros((240, 320)))
    pose_kf = np.array([1, 0, 0, 0, 0.5, -0.2, 1.0], np.float32)
    k = s.add_keyframe(pose_kf, 0, feat)
    pose_f = np.array([0.9689, 0.0, 0.2474, 0.0, 0.55, -0.2, 1.4], np.float32)
    tr = sys_.tracker
    tr.ref_kf = k
    tr.last_pose = pose_f
    tr._append_traj(7)
    assert tr.rel_traj[-1][1] == k

    # a loop / global BA correction of the keyframe
    new_pose_kf = np.array([0.9950, 0.0, 0.0998, 0.0, 2.0, 0.3, -1.0], np.float32)
    s.set_kf_pose(k, new_pose_kf)
    rec = dict(sys_.frame_trajectory_recomposed())
    Rr, trr = _kf_rt(pose_kf)
    Rc, tc = _kf_rt(pose_f)
    Rcr = Rc @ Rr.T
    rel = np.concatenate([_np_mat_to_quat(Rcr), tc - Rcr @ trr]).astype(np.float32)
    Re, te = _kf_rt(_apply_delta_host(rel, new_pose_kf))
    Rg, tg = _kf_rt(rec[7])
    np.testing.assert_allclose(Rg, Re, atol=1e-5)
    np.testing.assert_allclose(tg, te, atol=1e-5)


def test_culled_ref_walks_spanning_tree():
    """A culled ref KF bridges through its cull-time relative pose to the
    surviving parent (System.cc:523-528 semantics): 1e-5."""
    sys_ = _mk_system()
    s = sys_.store
    feat = sys_.extract(torch.zeros((240, 320)))
    kp = s.add_keyframe(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), 0, feat)
    kc = s.add_keyframe(np.array([1, 0, 0, 0, 0, 0, 1.0], np.float32), 1, feat)
    s.kf_parent[kc] = kp
    tr = sys_.tracker
    tr.ref_kf = kc
    tr.last_pose = np.array([1, 0, 0, 0, 0, 0, 1.5], np.float32)
    tr._append_traj(3)

    sys_.local_mapper._erase_keyframe(kc)  # captures kf_cull_rel
    assert not s.kf_valid[kc] and s.kf_cull_parent[kc] == kp
    s.set_kf_pose(kp, np.array([1, 0, 0, 0, 1.0, 0, 0], np.float32))
    rec = dict(sys_.frame_trajectory_recomposed())
    # T_cw = Tcr(child) o Tcp(child->parent) o T_parent_new, identity rotations
    np.testing.assert_allclose(rec[3][4:], [1.0, 0.0, 1.5], atol=1e-5)


def test_recomposed_matches_live_without_corrections():
    """On a short clean run with no loop closure, the recomposed and live
    frame trajectories agree to local-BA adjustment scale (the reference's
    bar, 0.25)."""
    cfg = small_config()
    frames, _ = render_u8(cfg, 20, step=0.25, turn=0.004)
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sys_ = System(cfg, descriptor_fn=patch_descriptor.apply, device="cpu")
        for i in range(frames.shape[0]):
            sys_.track_monocular(frames[i], i)
        sys_.finish()
    finally:
        torch.set_num_threads(torch_threads)
    live = evaluate.camera_centers(sys_.frame_trajectory())
    rec = evaluate.camera_centers(sys_.frame_trajectory_recomposed())
    common = sorted(set(live) & set(rec))
    assert len(common) >= 10
    d = np.array([np.linalg.norm(live[i] - rec[i]) for i in common])
    assert float(d.max()) < 0.25, d.max()
