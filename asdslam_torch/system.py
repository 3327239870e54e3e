"""System facade: wires extractor, tracker, local mapper, (loop closer).

Port of ``asdslam_tpu/system.py`` (mirror of src/vslam/src/System.cc —
construction 112-144, TrackMonocular 146-150, trajectory export 446-541):

    slam = System(SlamConfig(), asdnet_params=load_weights("asdnet_weights.pkl"),
                  do_loop_closing=True)
    for i, img in enumerate(frames):
        pose = slam.track_monocular(img, i)   # may lag one frame (pipelined)
    slam.finish()                             # drains the deferred frame, joins the worker

``SlamConfig()``'s defaults run the pipelined tracker and the asynchronous
mapping worker; ``cfg.replace(pipelined_tracking=False,
async_mapping=False)`` gives the synchronous mode.  It runs on ``device``
("cuda" unless the caller says otherwise).  A camera with lens distortion
(``cfg.dist_coeffs``, e.g. from ``io/datasets.py::read_cam_info``)
undistorts keypoints at extraction.  A map is saved and loaded as a binary
``.map`` file; localization mode tracks against a loaded map:

    slam.save_map("run.map")
    loc = System(cfg, asdnet_params=..., localization_mode=True)
    loc.load_map("run.map")        # then track_monocular as above

``cfg.n_devices > 1`` runs the loop closer's global BA over a mesh of that
many shards (``parallel/dist.py``).  ``save_debug_image`` writes the last
keyframe's overlay as a PNG without matplotlib (``viz.draw_debug_overlay``).
``cfg.use_orb`` is refused at construction for the reference's own reason
(``ORB_REFUSAL``).
"""

from __future__ import annotations

import subprocess
from typing import Optional

import numpy as np
import torch

from asdslam_torch import viz
from asdslam_torch.backend.local_mapping import LocalMapper
from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend import extractor as extractor_mod
from asdslam_torch.frontend.tracking import Tracker, _apply_delta_host, _np_mat_to_quat
from asdslam_torch.geometry import camera as camera_mod
from asdslam_torch.io import results
from asdslam_torch.loop.loop_closing import LoopCloser
from asdslam_torch.mapping import persistence
from asdslam_torch.mapping.map_store import MapStore, _pose_np
from asdslam_torch.models import asdnet
from asdslam_torch.utils.tracing import Tracer

_mat_to_quat_np = _np_mat_to_quat


ORB_REFUSAL = (
    "cfg.use_orb: the System refuses the ORB descriptor because the reference's map "
    "store is 128 wide (asdslam_tpu/mapping/map_store.py:76, 202), so its own use_orb "
    "System fails on its first bootstrap; ORB is ported as functions "
    "(asdslam_torch/ops/orb.py) and as the fused step's descriptor "
    "(make_extractor(cfg, orb.apply, rotate_patches=True)) (ROADMAP: Queue 3, use_orb)")


def require_device(name: str) -> torch.device:
    """The device a command-line entry point runs on: "cuda" (the scripts'
    default) or "cpu" where the caller asks for it.  Where "cuda" is asked
    for and there is no card it exits with a message: it never falls back
    to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def device_names(device):
    """(torch's name of the device, nvidia-smi's "name, power limit" line or
    None off a card)."""
    if device.type != "cuda":
        return "cpu", None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(device), card


class System:
    def __init__(self, cfg: SlamConfig, asdnet_params=None, do_loop_closing: bool = False,
                 descriptor_fn=None, localization_mode: bool = False, device="cuda"):
        """asdnet_params: an ``ASDNet`` state dict (``asdnet.load_weights``)
        or the reference's params dict (lists under "conv", "bn_mean",
        "bn_var"); None gives the seeded random weights.  descriptor_fn
        replaces the network: (patches [N, 32, 32]) -> [N, 128].

        localization_mode: track against a prior map (``load_map``) without
        extending it, unless ``cfg.loc_extend_map`` (System(loop_for_loc) /
        TrackLocalization parity)."""
        if descriptor_fn is None and cfg.use_orb:
            raise NotImplementedError(ORB_REFUSAL)
        self.localization_mode = localization_mode
        self.cfg = cfg
        self.device = torch.device(device)
        self.K = torch.tensor(
            [[cfg.fx, 0.0, cfg.cx], [0.0, cfg.fy, cfg.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=self.device)

        if descriptor_fn is None:
            net = asdnet.ASDNet()
            if asdnet_params is not None:
                if "conv" in asdnet_params:
                    asdnet_params = asdnet.params_from_jax(asdnet_params)
                net.load_state_dict(asdnet_params)
            self.asdnet = net.to(self.device)
            descriptor_fn = self.asdnet
        self.extract = extractor_mod.make_extractor(cfg, descriptor_fn)
        if cfg.has_distortion:
            # undistort keypoints at extraction (Frame::UndistortKeyPoints,
            # Frame.cc:298-328); downstream projection stays pinhole on
            # uv_und like the reference (EuRoC's radtan camera needs this)
            cam = camera_mod.Camera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                           *cfg.dist_coeffs, device=self.device)
            self.extract = extractor_mod.with_undistortion(self.extract, cam)

        self.store = MapStore(cfg.max_keyframes, cfg.max_map_points,
                              cfg.n_features, cfg.max_obs_per_point)
        self.loop_closer = None
        if do_loop_closing or localization_mode:
            self.loop_closer = LoopCloser(cfg, self.K, self.store, device=self.device)
            self.loop_closer.only_global_map = localization_mode
        self.local_mapper = LocalMapper(cfg, self.K, self.store, self.loop_closer,
                                        device=self.device)
        self.tracker = Tracker(cfg, self.K, self.extract, self.store,
                               self.local_mapper, localization_only=localization_mode,
                               device=self.device)
        self.tracer = Tracer()
        self.tracker.tracer = self.tracer
        self.local_mapper.tracer = self.tracer
        if self.loop_closer is not None:
            self.loop_closer.tracer = self.tracer

    @torch.no_grad()
    def track_monocular(self, image, frame_id: int) -> Optional[np.ndarray]:
        """image: [H, W] — float32 in [0, 1] or uint8 in [0, 255] (uint8
        uploads 4x less and is converted on device), a numpy array or a
        tensor.  Returns pose7 T_cw or None."""
        img = torch.as_tensor(image)
        if img.is_floating_point():
            img = img.to(torch.float32)
        with self.tracer.span("frame"):
            return self.tracker.process(img, frame_id)

    def finish(self):
        """Drain the pipelined tracker (deferred frame + outstanding
        asynchronous mapping).  Idempotent; called by the trajectory
        accessors so results are always complete."""
        self.tracker.flush()

    # ------------------------------------------------------------------ #
    def keyframe_trajectory(self):
        """[(frame_id, pose7 T_cw)] for all keyframes."""
        self.finish()
        s = self.store
        return [(int(s.kf_frame_id[k]), s.kf_pose[k].copy())
                for k in range(s.n_kf) if s.kf_valid[k]]

    def frame_trajectory(self):
        self.finish()
        return list(self.tracker.trajectory)

    def frame_trajectory_recomposed(self):
        """Reference-protocol frame trajectory (System::SaveTrajectoryTUM,
        src/vslam/src/System.cc:482-541): each frame's stored ref-KF-relative
        pose (Tracking.cc:371-375) composed onto the ref KF's FINAL optimized
        pose, walking cull-time relative links (System.cc:523-528) when the
        ref KF was culled.  Later corrections of the keyframes therefore
        repair the whole frame trajectory — this is the trajectory the
        reference evaluates; the live ``frame_trajectory`` is the stricter
        poses-as-estimated-online variant."""
        self.finish()
        s = self.store
        out = []
        for fid, ref, rel in self.tracker.rel_traj:
            if ref < 0:
                out.append((fid, np.asarray(rel).copy()))
                continue
            T = np.asarray(rel)
            k = int(ref)
            guard = 0
            while (not s.kf_valid[k] and s.kf_cull_parent[k] >= 0
                   and guard < 256):
                T = _apply_delta_host(T, s.kf_cull_rel[k])
                k = int(s.kf_cull_parent[k])
                guard += 1
            if not s.kf_valid[k]:
                continue  # no surviving anchor: skip (reference drops too)
            out.append((fid, _apply_delta_host(T, s.kf_pose[k])))
        return out

    @staticmethod
    def _write_tum(path: str, traj, timestamps):
        """TUM format: ts tx ty tz qx qy qz qw, pose = T_wc (inverted)."""
        with open(path, "w") as f:
            for frame_id, pose7 in traj:
                R, t = _pose_np(pose7)
                Rwc = R.T
                twc = -R.T @ t
                q = _mat_to_quat_np(Rwc)
                ts = frame_id if timestamps is None else timestamps[frame_id]
                f.write("%f %f %f %f %f %f %f %f\n" % (
                    ts, twc[0], twc[1], twc[2], q[1], q[2], q[3], q[0]))

    def save_frame_trajectory_tum(self, path: str, timestamps=None,
                                  recomposed: bool = True):
        """System::SaveTrajectoryTUM parity: per-FRAME trajectory in TUM
        format, recomposed through the final keyframe poses by default."""
        traj = (self.frame_trajectory_recomposed() if recomposed
                else self.frame_trajectory())
        self._write_tum(path, traj, timestamps)

    def save_trajectory_tum(self, path: str, timestamps=None):
        """Keyframe trajectory in TUM format."""
        self._write_tum(path, self.keyframe_trajectory(), timestamps)

    def save_map(self, path: str):
        """Binary .map checkpoint (visual_map format parity — System.cc:437)."""
        self.finish()
        data = persistence.export_map(self.store, self.cfg,
                                      self.cfg.covis_weight_posegraph)
        persistence.save_visual_map(data, path)

    def load_map(self, path: str):
        """Load a .map into the (empty) store — System::LoadORBMap.  In
        localization mode also builds the relocalization BoW database."""
        data = persistence.load_visual_map(path)
        persistence.import_map(data, self.store,
                               np.asarray(self.cfg.scale_factors, np.float32),
                               device=self.device)
        if self.localization_mode and self.loop_closer is not None:
            lc = self.loop_closer
            if lc.vocab is None:
                # no offline vocabulary supplied: train one from the loaded
                # map's own descriptors
                lc.pending = list(range(self.store.n_kf))
                lc._train_vocab()
            else:
                # offline vocabulary (train_vocab.py / --voc_addr): index the
                # prior map's keyframes under it
                for kf in range(self.store.n_kf):
                    lc._add_kf_bow(kf)
                    lc.db.add(kf, lc.kf_bow[kf])

    def save_result(self, out_dir: str, filenames=None):
        """Plain-text map dump (track/desc/kps/posi/traj.txt) —
        System::saveResult parity (System.cc:548-661)."""
        results.save_result(self.store, out_dir, filenames)

    def save_debug_image(self, path: str, image=None):
        """getDebugImg parity incl. the visual overlay (System.cc:214-261):
        the last keyframe's observed keypoints and the reprojections of its
        map points over ``image`` (an optional [H, W] gray backdrop, e.g.
        the keyframe's frame; else a black canvas of the config's size),
        with the reference's title, written as an RGB PNG
        (``viz.draw_debug_overlay``; no matplotlib).  Returns the stats
        dict of ``debug_info``."""
        info, proj, obs_uv, ok = self.debug_info()
        if isinstance(image, torch.Tensor):
            image = image.detach().cpu().numpy()
        caption = viz.debug_caption(info)
        img = viz.draw_debug_overlay((self.cfg.image_height, self.cfg.image_width),
                                     obs_uv, proj, ok, caption, backdrop=image)
        viz.write_png_rgb(path, img, text=caption)
        return info

    def stats(self):
        # deliberately does NOT flush the pipeline: it is called from
        # per-frame progress prints, and a flush there would break the
        # dispatch-ahead overlap.  Counts may lag by one frame.
        s = self.store
        return {
            "n_keyframes": int(s.kf_valid.sum()),
            "n_map_points": int(s.mp_valid.sum()),
            "n_frames_tracked": len(self.tracker.trajectory),
            "state": self.tracker.state,
        }

    def debug_info(self):
        """Reprojection diagnostics of the last keyframe — getDebugImg
        parity (System.cc:214-261) minus the overlay: projects the KF's
        associated map points with its optimized pose and reports the mean
        pixel reprojection error plus match/map counts.  Returns
        (stats dict, projected uv [N, 2], observed uv [N, 2], mask [N])."""
        s = self.store
        kfs = [k for k in range(s.n_kf) if s.kf_valid[k]]
        info = dict(self.stats(), mean_reproj_err=float("nan"), n_matches=0)
        if not kfs:
            return info, None, None, None
        k = kfs[-1]
        h = s.kf_host[k]
        mp = s.kf_mp[k]
        has = (mp >= 0) & s.mp_valid[np.where(mp >= 0, mp, 0)]
        if not has.any():
            return info, None, None, None
        R, t = _pose_np(s.kf_pose[k])
        X = s.mp_pos[np.where(has, mp, 0)]
        xc = X @ R.T + t
        z = np.where(np.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
        K = self.K.cpu().numpy()
        u = K[0, 0] * xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * xc[:, 1] / z + K[1, 2]
        proj = np.stack([u, v], 1)
        err = np.linalg.norm(proj - h.uv_und, axis=1)
        ok = has & (xc[:, 2] > 0)
        info["n_matches"] = int(ok.sum())
        info["mean_reproj_err"] = float(err[ok].mean()) if ok.any() else float("nan")
        return info, proj, h.uv_und, ok
