"""Tracking front-end: the per-frame state machine.

Port of ``asdslam_tpu/frontend/tracking.py`` — host-side orchestration of
device functions, mirroring src/vslam/src/Tracking.cc:

- states NO_IMAGES -> NOT_INITIALIZED -> OK/LOST (Tracking.h:76-82)
- MonocularInitialization + CreateInitialMapMonocular (Tracking.cc:385-589)
- the fused per-frame step (frontend/track_step.py) with the staged paths
  behind it: TrackWithMotionModel (664-723, with the <20-matches widened
  retry), TrackReferenceKeyFrame (609-653), relocalization (1095-1266, BoW
  candidates from the loop closer's vocabulary and database when there is
  one)
- TrackLocalMap (725-767) over a covisibility window capped at 80 KFs
- NeedNewKeyFrame / CreateNewKeyFrame (770-801)

and the two latency-hiding modes the reference adds (no counterpart in the
original, which is single-threaded), both on by default:

- ``cfg.pipelined_tracking``: frame t's fused step is queued before frame
  t-1's result is fetched (``_dispatch_fused`` reads nothing back;
  ``_commit_fused`` fetches the small bundle in one transfer);
- ``cfg.async_mapping``: a keyframe's triangulation runs inline, its fuse,
  local BA, keyframe culling and loop closing in a worker thread on a CUDA
  stream of its own, joined at the fixed frame offset
  ``cfg.mapping_overlap_frames`` (or at the next keyframe or staged
  fallback), never when it happens to finish.  While the worker runs the
  tracker reads none of the store's point fields: it buffers its visibility
  counts and resolves its bindings at the join.

All matching / optimization happens in fixed-shape device functions; the
host only sequences them and updates the SoA map store.  Each call site
fetches its results once, after its last launch is queued.

``localization_only`` (System(localization_mode=True), Tracking::Loc):
the tracker starts by relocalizing against a loaded prior map instead of
bootstrapping, never resets or re-initializes after a loss, and inserts
keyframes only with ``cfg.loc_extend_map`` (``_may_insert_kfs``).

Random draws (the RANSAC sample matrices) come from ``Tracker._draws``: a
CPU ``torch.Generator`` seeded 42, so a CPU run and a CUDA run see the same
draws; a test may replace the method to replay another stream.

The staged paths', the relocalization's and the bootstrap's device functions
are module-level ``graphs.captured`` callables (the reference jits each), so
on the card each call replays a CUDA graph: the window search and the
two-view initializer, the global search, PnP RANSAC, pose-only BA, the
motion model's projection search, and the projection searches of the local
map and of the relocalization's widening (``project_search``).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from asdslam_torch.backend import ba
from asdslam_torch.config import SlamConfig
from asdslam_torch.estimators import pnp as pnp_mod
from asdslam_torch.estimators import twoview
from asdslam_torch.frontend import track_step as track_step_mod
from asdslam_torch.frontend import visibility
from asdslam_torch.geometry import se3
from asdslam_torch.loop import vocab as vocab_mod
from asdslam_torch.mapping.map_store import MapStore, _pose_np
from asdslam_torch.ops import match
from asdslam_torch.utils import graphs
from asdslam_torch.utils.tracing import Tracer

NO_IMAGES = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3


def two_view(g, uv1, uv2, valid, K, sigma: float, min_triangulated: int):
    """``twoview.initialize_two_view`` (jitted in the reference,
    twoview.py:270) and the second view's pose7.  Returns (success, good,
    pose2, points)."""
    res = twoview.initialize_two_view(g, uv1, uv2, valid, K, sigma=sigma,
                                      min_triangulated=min_triangulated)
    return res.success, res.good, se3.pose_pack(res.R, res.t), res.points


def motion_search(*args, **kwargs):
    """``match.search_projection`` as it stands at the call (a check may
    wrap it): the motion model's search of the last frame's points."""
    return match.search_projection(*args, **kwargs)


def project_search(pose7, K, pos, normal, min_dist, max_dist_mp, valid_a, desc_a,
                   desc_b, uv_b, valid_b, levels_b, skip_b, scale_dev, radius: float, bounds,
                   max_dist: float, ratio: float, min_view_cos: float, scale_factor: float,
                   n_levels: int, use_kernel: bool):
    """SearchByProjection of a padded block of map points through the pose
    estimate ``pose7`` into the current frame's features (the local map's,
    the relocalization's widening): ``visibility.project_points``, radius x
    the predicted level's scale, ``match.search_projection`` with the level
    gate, skipping the features in ``skip_b``.  Returns (idx, ok)."""
    bx0, bx1, by0, by1 = bounds
    uv, pred_level, _, vis = visibility.project_points(
        pose7, K, pos, normal, min_dist, max_dist_mp, valid_a, bx1, by1, scale_factor,
        n_levels, min_view_cos=min_view_cos, x_min=bx0, y_min=by0)
    radii = radius * scale_dev[pred_level.to(torch.int64)]
    idx, _, ok = match.search_projection(
        desc_a, desc_b, uv, uv_b, vis, valid_b, radii, max_dist, ratio=ratio,
        pred_level_a=pred_level, levels_b=levels_b, skip_b=skip_b, use_kernel=use_kernel)
    return idx, ok


_search_window = graphs.captured(match.search_window, "search_window")
_two_view = graphs.captured(two_view, "initialize_two_view")
_search_global = graphs.captured(match.search_global, "track_search_global")
_ransac_pnp = graphs.captured(pnp_mod.ransac_pnp, "ransac_pnp")
_pose_only = graphs.captured(ba.pose_only_optimize, "pose_only_optimize")
_motion_search = graphs.captured(motion_search, "motion_search")
_project_search = graphs.captured(project_search, "project_search")


def cfg_giveup(cfg) -> int:
    """Consecutive lost frames before giving up on relocalization and
    re-initializing (4x the max KF step: far beyond any transient loss the
    reference's relocalizer recovers from)."""
    return 4 * cfg.max_step_kf


def _fetch(*tensors):
    """The tensors as numpy arrays: the call site's one synchronisation
    (the first copy waits for the queued work, the rest are ready)."""
    return tuple(t.cpu().numpy() for t in tensors)


def _fetch_small(res):
    """(pose, velocity, src, n_motion, n_track, n_inliers) of a step's
    result as numpy, in ONE device-to-host transfer: the floats travel as
    their int32 bit patterns beside the int32 codes and counts."""
    packed = torch.cat([
        res.pose.view(torch.int32), res.velocity.view(torch.int32),
        res.src.to(torch.int32),
        torch.stack([res.n_motion, res.n_track, res.n_inliers]).to(torch.int32)]).cpu().numpy()
    n = res.src.shape[0]
    pose, velocity = packed[:7].view(np.float32).copy(), packed[7:14].view(np.float32).copy()
    n_motion, n_track, n_in = (int(x) for x in packed[14 + n:])
    return pose, velocity, packed[14:14 + n], n_motion, n_track, n_in


class Tracker:
    def __init__(self, cfg: SlamConfig, K, extractor, store: MapStore, local_mapper=None,
                 localization_only: bool = False, device="cuda"):
        self.localization_only = localization_only
        self.cfg = cfg
        self.device = torch.device(device)
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.extract = extractor
        self.store = store
        self.local_mapper = local_mapper
        self.state = NO_IMAGES

        self.scale_factors = np.asarray(cfg.scale_factors, np.float32)
        self.inv_sigma2 = np.asarray(cfg.inv_level_sigma2, np.float32)
        self._scale_dev = torch.as_tensor(self.scale_factors).to(self.device)
        self._inv_sigma2_dev = torch.as_tensor(self.inv_sigma2).to(self.device)
        self._desc_dtype = torch.bfloat16 if cfg.desc_upload_bf16 else torch.float32
        # frustum bounds from undistorted corners (Frame.cc:330-358)
        self._bx0, self._bx1, self._by0, self._by1 = cfg.undistorted_bounds

        self._fused = track_step_mod.make_track_step(
            cfg, self.K, self.extract, device=self.device)
        # device-resident fused-path state (avoids per-frame host uploads)
        self._device_geom = None       # GeomBlock for the next frame
        self._device_cand = None       # PointBlock, refreshed at KF rate
        self._cand_ids = None          # np [P] map-point id per cand row
        self._cand_epoch = 0           # bumped on every cand-block rebuild
        self._remap = None             # (from_epoch, [P] device row remap)
        #                                bridging a KF-time block rebuild

        # ---- pipelined tracking state (cfg.pipelined_tracking) ---------- #
        # dispatched-but-uncommitted frame: (frame_id, feat, res, cand_ids,
        # cand_epoch), the last two as they stood at dispatch
        self._pend = None
        # ---- asynchronous mapping state (cfg.async_mapping) ------------- #
        self._map_thread = None        # active mapping worker (or None)
        self._map_exc = []             # exception raised inside the worker
        self._map_kf = -1              # KF id the worker is mapping
        self._map_kf_pose0 = None      # its pose at spawn (for the relative
        #                                correction applied at join)
        self._map_loops0 = 0           # loop count at spawn
        self._buf_found = []           # mp-id arrays buffered during overlap
        self._buf_visible = []
        # the worker's own stream: its launches overlap the tracker's
        self._map_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                            else None)
        self.tracer = Tracer(enabled=False)  # System installs a live one

        # init buffers
        self._init_feat = None
        self._init_frame_id = None
        self._init_fail_count = 0
        # re-seeded whenever __init__ runs again (_reset), as the reference
        # restarts from its key 42
        self._gen = torch.Generator(device="cpu").manual_seed(42)

        # per-frame state
        self.last_feat = None
        self.last_pose = None          # np [7]
        self.last_mp = None            # np [N] mp id per feature (-1)
        self.last_frame_id = None
        self.velocity = None           # np [7]: T_cur * T_last^-1
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.n_inliers = 0
        self._lost_streak = 0          # consecutive untracked frames

        self.trajectory = []           # (frame_id, pose7) after each frame
        # reference-protocol relative trajectory (Tracking.cc:371-375 pushes
        # Tcr per frame): (frame_id, ref_kf, Tcr7) with Tcr = T_cw * T_rw^-1
        # against the ref KF's pose AS THE TRACKER KNEW IT at that frame.
        # Recomposed at save time so later corrections of the keyframes
        # repair the whole frame trajectory (System::SaveTrajectoryTUM,
        # System.cc:482-541).
        self.rel_traj = []
        self._ref_snapshot = None      # (ref_kf, pose7) consistent with the
        #                                tracker's current coordinate frame
        if self.device.type == "cuda":
            # the constants above (K, the LUTs, the step's own) are queued on
            # this thread's stream: settle them once, so that any stream may
            # read them from now on
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    def _upload(self, t):
        """A tensor on the tracker's device.  From the host to a CUDA device
        it goes through pinned memory without waiting: the host never blocks
        on an upload."""
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _dev(self, x, dtype=None):
        """A host array on the tracker's device."""
        t = self._upload(torch.as_tensor(np.ascontiguousarray(x)))
        return t if dtype is None else t.to(dtype)

    def _upload_image(self, image):
        """The frame on the tracker's device (uint8 stays uint8: the step
        converts on the device)."""
        return self._upload(torch.as_tensor(image))

    def _draws(self, kind: str, iters: int, n: int, seed=None):
        """[iters, n] uniform draws in [0, 1) on the device.  ``kind`` is
        "twoview" (the tracker's running stream) or "pnp" (a stream of its
        own from ``seed``, as the reference keys each PnP by keyframe count
        and candidate)."""
        gen = self._gen if seed is None else torch.Generator(device="cpu").manual_seed(seed)
        return torch.rand((iters, n), generator=gen, dtype=torch.float32).to(self.device)

    @property
    def _may_insert_kfs(self) -> bool:
        """SLAM mode always inserts keyframes; localization mode only with
        cfg.loc_extend_map (the reference's Loc-mode map extension — new
        entities stay GlobalMapFlag=False, distinguishing them from the
        loaded prior map)."""
        return (not self.localization_only) or self.cfg.loc_extend_map

    # ------------------------------------------------------------------ #
    def process(self, image, frame_id: int) -> Optional[np.ndarray]:
        """Track one frame.  In pipelined mode (cfg.pipelined_tracking) the
        returned pose may lag one frame: frame t's fused step is queued
        before frame t-1's result is fetched, so this call usually returns
        t-1's pose and defers t's.  ``trajectory`` always carries the
        correct (frame_id, pose) pairs; call ``flush()`` after the last
        frame to drain the pipeline."""
        if self.cfg.pipelined_tracking and (
                self._pend is not None or self._fused_eligible()):
            return self._process_pipelined(image, frame_id)
        return self._process_sync(image, None, frame_id)

    def flush(self):
        """Drain the dispatch pipeline and join outstanding mapping work.
        Call after the last frame (idempotent)."""
        if self._pend is not None:
            pend, self._pend = self._pend, None
            with self.tracer.span("fused_track"):
                self._commit_fused(*pend)
        self._join_mapping()

    def _append_traj(self, frame_id: int):
        """Record the frame in both trajectories: live pose, and the
        reference-KF-relative pose used for save-time recomposition."""
        self.trajectory.append((frame_id, self.last_pose.copy()))
        ref = self.ref_kf
        if ref is None or ref < 0 or ref >= self.store.n_kf:
            self.rel_traj.append((frame_id, -1, self.last_pose.copy()))
            return
        if self._map_thread is None:
            # worker inactive: the store is current — refresh the snapshot
            self._ref_snapshot = (ref, self.store.kf_pose[ref].copy())
        snap = self._ref_snapshot
        if snap is None or snap[0] != ref:
            self.rel_traj.append((frame_id, -1, self.last_pose.copy()))
            return
        Rr, tr = _kf_rt(snap[1])
        Rc, tc = _kf_rt(self.last_pose)
        Rcr = Rc @ Rr.T
        tcr = tc - Rcr @ tr
        self.rel_traj.append((frame_id, int(ref), np.concatenate(
            [_np_mat_to_quat(Rcr), tcr]).astype(np.float32)))

    # ---- pipelined engine --------------------------------------------- #
    def _process_pipelined(self, image, frame_id: int) -> Optional[np.ndarray]:
        with self.tracer.span("fused_track"):
            stale_pend = (self._pend is not None
                          and self._pend[4] != self._cand_epoch
                          and not (self._remap is not None
                                   and self._remap[0] == self._pend[4]))
            if stale_pend:
                # pipeline bubble: the candidate block was invalidated at a
                # join — the pending frame's chain refers to the old block.
                # Realign: commit it now, then restart the chain from host
                # state (fresh post-BA geometry) below.
                pend, self._pend = self._pend, None
                if not self._commit_fused(*pend):
                    # its staged fallback already ran; the current frame
                    # takes the sync path from the recovered state
                    return self._process_sync(image, None, frame_id)
            feat, res = self._dispatch_fused(image)
            if feat is None:
                return self._process_sync(image, None, frame_id)
            # snapshot the decode table/epoch AT DISPATCH: committing the
            # previous frame below may join mapping and invalidate the live
            # candidate block, but this frame's codes refer to this table
            disp_cand_ids, disp_epoch = self._cand_ids, self._cand_epoch
            out = None
            if self._pend is not None:
                pend, self._pend = self._pend, None
                if not self._commit_fused(*pend):
                    # pending frame failed its gates and was recovered via
                    # the staged path; the current speculative result is
                    # stale — reuse only its extracted features
                    return self._process_sync(image, feat, frame_id)
                out = self.last_pose
            self._pend = (frame_id, feat, res, disp_cand_ids, disp_epoch)
            return out

    def _process_sync(self, image, feat, frame_id: int) -> Optional[np.ndarray]:
        if feat is None and self._fused_eligible():
            with self.tracer.span("fused_track"):
                feat, ok = self._try_fused(image, frame_id)
            if ok:
                self._append_traj(frame_id)
                return self.last_pose
            # fused step failed its gates: fall through to the staged path
            # (reference-KF fallback / relocalization) with `feat` reused.
        self._join_mapping()             # staged path reads/mutates the map
        self._invalidate_device_state()
        if feat is None:
            with self.tracer.span("extract"):
                image = self._upload_image(image)
                if not image.is_floating_point():
                    image = image.to(torch.float32) / 255.0
                feat = self.extract(image)
        if self.state in (NO_IMAGES, NOT_INITIALIZED):
            self.state = NOT_INITIALIZED
            if self.localization_only and self.store.n_kf > 0:
                # localization mode (Tracking::Loc): relocalize against the
                # prior map instead of two-view bootstrapping
                with self.tracer.span("relocalize"):
                    ok = self._relocalize(feat)
                if ok:
                    self.state = OK
                    self._save_frame(feat, frame_id, tracked=True)
                    self.last_mp = self.cur_mp.copy()
            else:
                with self.tracer.span("initialize"):
                    self._try_initialize(feat, frame_id)
        elif self.state == OK:
            with self.tracer.span("staged_track"):
                self._track(feat, frame_id)
        else:  # LOST: relocalize (Tracking::Relocalization, Tracking.cc:1095-1266)
            with self.tracer.span("relocalize"):
                ok = self._relocalize(feat) or self._track_reference_kf(feat)
            if ok:
                self.state = OK
                self._after_pose(feat, frame_id)
            else:
                self._save_frame(feat, frame_id, tracked=False)
                # after a prolonged loss the camera has left the map's
                # visibility: relocalization is hopeless and the reference
                # would stay LOST forever.  Reset and bootstrap a fresh map
                # instead (odometry resumes; the trajectory restarts in the
                # new epoch's frame).  Never in localization mode: the
                # prior map is what the tracker localizes against.
                if (not self.localization_only
                        and self._lost_streak > cfg_giveup(self.cfg)):
                    self._reset()
                    self.state = NOT_INITIALIZED
        if self.last_pose is not None and self.state == OK:
            self._append_traj(frame_id)
            return self.last_pose
        return None

    # ------------------------------------------------------------------ #
    # Fused device-resident fast path (track_step.py): extract + motion
    # model + pose BA + local map + pose BA as one function with a single
    # device->host fetch per frame.
    # ------------------------------------------------------------------ #
    def _fused_eligible(self) -> bool:
        return (self.state == OK and self.velocity is not None
                and self.last_mp is not None
                and int((self.last_mp >= 0).sum()) >= 10)

    def _select_local_window(self, bound_mps: np.ndarray):
        """Vectorized UpdateLocalKeyFrames (Tracking.cc:907-1015): rank KFs by
        how many of the given map points they observe, extend with covisible
        neighbours up to the 80-KF cap.  Returns (ref_kf, local_kfs list)."""
        store = self.store
        cfg = self.cfg
        obs = store.mp_obs_kf[bound_mps]
        flat = obs[obs >= 0]
        if flat.size == 0:
            return -1, []
        kfs, counts = np.unique(flat, return_counts=True)
        order = np.argsort(-counts)
        local_kfs = [int(k) for k in kfs[order]]
        ref_kf = local_kfs[0]
        seen = set(local_kfs)
        for kf in list(local_kfs):
            if len(local_kfs) >= cfg.local_window_kfs:
                break
            for nb in store.covisible_kfs(kf, min_weight=cfg.covis_weight_graph,
                                          max_n=10):
                if nb not in seen and len(local_kfs) < cfg.local_window_kfs:
                    seen.add(nb)
                    local_kfs.append(int(nb))
        return ref_kf, local_kfs

    def _invalidate_device_state(self):
        """Drop device-resident fused-path caches — call whenever the host
        map changes under them (KF insertion/mapping/loop closure, staged
        tracking, reset).  Bumps the candidate-block epoch so a pending
        pipelined frame (whose chain refers to the old block) is realigned
        through the bubble path before the next dispatch."""
        self._device_geom = None
        self._device_cand = None
        self._cand_ids = None
        self._cand_epoch += 1
        self._remap = None

    def _build_prev_geom(self):
        store = self.store
        last_mp = self.last_mp
        has = last_mp >= 0
        mp_ids = np.where(has, last_mp, 0)
        return track_step_mod.GeomBlock(
            pos=self._dev(store.mp_pos[mp_ids]),
            normal=self._dev(store.mp_normal[mp_ids]),
            min_dist=self._dev(store.mp_min_dist[mp_ids]),
            max_dist=self._dev(store.mp_max_dist[mp_ids]),
            valid=self._dev(has & store.mp_valid[mp_ids]))

    def _build_cand_block(self, bound):
        """Candidate PointBlock from the local covisibility window, uploaded
        once and reused until the map changes (KF rate)."""
        cfg = self.cfg
        store = self.store
        ref_kf, local_kfs = self._select_local_window(bound)
        if ref_kf < 0:
            return False
        mp_all = store.local_map_points(local_kfs)
        cand = np.setdiff1d(mp_all, bound, assume_unique=False)
        P = cfg.local_ba_max_points
        cand = cand[:P]
        n_c = len(cand)
        cand_p = np.pad(cand, (0, P - n_c), constant_values=-1).astype(np.int64)
        safe = np.where(cand_p >= 0, cand_p, 0)
        cand_valid = np.pad(np.ones(n_c, bool), (0, P - n_c))
        self._device_cand = track_step_mod.PointBlock(
            pos=self._dev(store.mp_pos[safe]),
            normal=self._dev(store.mp_normal[safe]),
            min_dist=self._dev(store.mp_min_dist[safe]),
            max_dist=self._dev(store.mp_max_dist[safe]),
            desc=self._dev(store.mp_desc[safe], self._desc_dtype),
            valid=self._dev(cand_valid & store.mp_valid[safe]))
        self._cand_ids = cand_p
        self.ref_kf = ref_kf
        return True

    def _host_crow(self) -> np.ndarray:
        """[N] int32: candidate-block row of each previous-frame feature's
        bound map point (-1 if unbound / not a row).  Host-side seed of the
        device crow recurrence, computed at chain restarts (right after a
        block rebuild most entries are -1 — bound points are excluded at
        build — but a mid-chain restart can find live bindings)."""
        N = self.cfg.n_features
        crow = np.full(N, -1, np.int32)
        if self.last_mp is None or self._cand_ids is None:
            return crow
        has = self.last_mp >= 0
        if not has.any():
            return crow
        order = np.argsort(self._cand_ids, kind="stable")
        sc = self._cand_ids[order]
        q = self.last_mp[has]
        pos = np.clip(np.searchsorted(sc, q), 0, len(sc) - 1)
        hit = sc[pos] == q
        crow[np.nonzero(has)[0][hit]] = order[pos[hit]]
        return crow

    def _dispatch_fused(self, image):
        """Queue the fused step for one frame WITHOUT reading anything back.
        Chain dispatch (a pending frame exists) feeds the previous dispatch's
        device outputs straight back in; a chain restart rebuilds the
        device blocks from host state (joining any mapping worker first —
        host reads must not race it).  Returns (feat, res) or (None, None)
        when the fused path is not available."""
        img = self._upload_image(image)
        if self._pend is not None:
            _, pfeat, pres, _, pepoch = self._pend
            crow = pres.crow
            if pepoch != self._cand_epoch:
                # only reachable through a KF-time rebuild that published a
                # row remap (every other mismatch takes the bubble path)
                crow = _remap_crow(crow, self._remap[1])
            with self.tracer.span("dispatch"):
                return self._fused(img, pres.pose, pres.velocity, pfeat,
                                   pres.next_geom, self._device_cand, crow)
        # chain restart from host state
        self._join_mapping()
        if not self._fused_eligible():
            return None, None
        store = self.store
        if self._device_cand is None:
            last_mp = self.last_mp
            has = last_mp >= 0
            bound = last_mp[has & store.mp_valid[np.where(has, last_mp, 0)]]
            with self.tracer.span("cand_upload"):
                if not self._build_cand_block(bound):
                    return None, None
        with self.tracer.span("dispatch"):
            return self._fused(img, self._dev(self.last_pose),
                               self._dev(self.velocity), self.last_feat,
                               self._build_prev_geom(), self._device_cand,
                               self._dev(self._host_crow()))

    def _commit_fused(self, frame_id: int, feat, res, cand_ids, epoch) -> bool:
        """Fetch a dispatched frame's small result bundle (one transfer) and
        commit it: decode bindings, bookkeeping, trajectory, keyframe
        policy, deterministic mapping join.  On gate failure runs the staged
        fallback for this frame (reusing its extracted features) and returns
        False."""
        cfg = self.cfg
        store = self.store
        with self.tracer.span("kernel"):
            pose, velocity, src, n_motion, n_track, n_in = _fetch_small(res)
        if (n_motion < cfg.min_motion_matches
                or n_track < cfg.min_track_matches
                or n_in < cfg.min_localmap_matches):
            # staged fallback for THIS frame (reference-KF / relocalization)
            self._join_mapping()
            self._invalidate_device_state()
            self._process_sync(None, feat, frame_id)
            return False

        overlap = self._map_thread is not None
        # decode match source codes -> map-point bindings (via the candidate
        # table snapshotted at dispatch — the live one may have been rebuilt)
        N = cfg.n_features
        last_mp = self.last_mp
        cur_mp = np.full(N, -1, np.int32)
        m1 = (src >= 0) & (src < N)
        cur_mp[m1] = last_mp[src[m1]]
        m2 = src >= N
        cur_mp[m2] = cand_ids[src[m2] - N]
        if not overlap:
            # resolve merges/culls (no store reads while the worker runs —
            # stale ids are resolved for the whole binding set at join)
            has = cur_mp >= 0
            rs = store.resolve_replacements(cur_mp)
            ok_mp = has & (rs >= 0) & store.mp_valid[np.where(rs >= 0, rs, 0)]
            cur_mp = np.where(ok_mp, rs, -1).astype(np.int32)
        # first-wins dedup: the stale-bound-mask window around a rebuild can
        # double-bind one point to two features
        rows = np.nonzero(cur_mp >= 0)[0]
        if len(rows):
            first = np.zeros(len(rows), bool)
            first[np.unique(cur_mp[rows], return_index=True)[1]] = True
            cur_mp[rows[~first]] = -1

        # bookkeeping (TrackLocalMap's IncreaseVisible/IncreaseFound);
        # buffered while the mapping worker owns the store
        cand_live = cand_ids[cand_ids >= 0]
        found = cur_mp[cur_mp >= 0]
        if overlap:
            self._buf_visible.append(cand_live)
            self._buf_visible.append(found)
            self._buf_found.append(found)
        else:
            store.mp_visible[cand_live] += 1
            store.mp_found[found] += 1
            store.mp_visible[found] += 1

        self._prev_pose = self.last_pose.copy()
        self.last_pose = pose
        self.velocity = velocity
        self.cur_mp = cur_mp
        self.n_inliers = n_in
        self._save_frame(feat, frame_id, tracked=True)
        self._append_traj(frame_id)
        self.last_mp = cur_mp.copy()

        # keyframe policy: the reference trigger, unmodified (inliers <
        # min_match_count OR max_step frames — Tracking.cc:770-779).  Never
        # in localization mode, loc_extend_map or not: the reference's
        # pipelined commit tests localization_only where the staged paths
        # test _may_insert_kfs (reference tracking.py:487 vs :679, :869)
        if not self.localization_only and self._need_new_kf(frame_id):
            self._join_mapping()     # a previous mapping pass completes first
            with self.tracer.span("create_kf"):
                self._create_new_kf(feat, frame_id, async_ok=True)
        elif (self._map_thread is not None and
              frame_id - self.last_kf_frame_id >= cfg.mapping_overlap_frames):
            # deterministic join point: mapping results are applied exactly
            # mapping_overlap_frames after the keyframe, never "when the
            # thread happens to finish"
            self._join_mapping()
        return True

    # ---- asynchronous mapping ----------------------------------------- #
    def _rebuild_cand_after_kf(self):
        """Rebuild the device candidate block right after the synchronous
        triangulation phase, and publish a row-remap so the in-flight
        pipelined frame's device chain bridges the rebuild without a
        pipeline bubble (its crow codes refer to the OLD block's rows)."""
        store = self.store
        old_ids = self._cand_ids
        old_epoch = self._cand_epoch
        had_pend = self._pend is not None
        last_mp = self.last_mp
        has = last_mp >= 0
        bound = last_mp[has & store.mp_valid[np.where(has, last_mp, 0)]]
        with self.tracer.span("cand_upload"):
            ok = self._build_cand_block(bound)
        if not ok:
            self._invalidate_device_state()
            return
        self._cand_epoch = old_epoch + 1
        if had_pend and old_ids is not None:
            new_ids = self._cand_ids
            remap = np.full(len(old_ids), -1, np.int32)
            order = np.argsort(new_ids, kind="stable")
            sc = new_ids[order]
            live = old_ids >= 0
            pos = np.clip(np.searchsorted(sc, old_ids[live]), 0, len(sc) - 1)
            hit = sc[pos] == old_ids[live]
            remap[np.nonzero(live)[0][hit]] = order[pos[hit]]
            self._remap = (old_epoch, self._dev(remap))
        else:
            self._remap = None

    def _spawn_mapping(self, kf: int, phase_b_only: bool = False):
        """Run the keyframe's mapping pass in a worker thread.  On a CUDA
        device the worker queues its launches on the tracker's mapping
        stream, which first waits for everything this thread has queued
        (the keyframe's features included); the worker drains its stream
        before it ends, so whatever it made is complete at the join."""
        lc = self.local_mapper.loop_closer
        self._map_kf = kf
        self._map_kf_pose0 = self.store.kf_pose[kf].copy()
        self._map_loops0 = lc.n_loops_closed if lc is not None else 0
        self._map_exc = []
        target = (self.local_mapper.process_phase_b if phase_b_only
                  else self.local_mapper.process)
        stream = self._map_stream
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(self.device))

        def run():
            try:
                with torch.no_grad(), torch.cuda.stream(stream):
                    target(kf)
                    if stream is not None:
                        stream.synchronize()
            except BaseException as e:  # re-raised at join
                self._map_exc.append(e)

        t = threading.Thread(target=run, name="asdslam-mapping", daemon=True)
        self._map_thread = t
        t.start()

    def _join_mapping(self):
        """Join the mapping worker and apply its effects to the tracker:
        buffered visibility counters, binding resolution (points merged or
        culled by the mapper), the relative pose correction for the BA's
        adjustment of the keyframe, and device-state invalidation so the
        next dispatch realigns to the post-mapping map."""
        if self._map_thread is None:
            return
        with self.tracer.span("join_mapping"):
            self._map_thread.join()
        self._map_thread = None
        if self._map_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._map_stream)
        if self._map_exc:
            exc = self._map_exc[0]
            self._map_exc = []
            raise exc
        store = self.store
        self._apply_buffers()
        # resolve tracker bindings against the mapper's merges/culls
        for name in ("last_mp", "cur_mp"):
            arr = getattr(self, name, None)
            if arr is None:
                continue
            rs = store.resolve_replacements(arr)
            ok = (rs >= 0) & store.mp_valid[np.where(rs >= 0, rs, 0)]
            setattr(self, name, np.where(ok, rs, -1).astype(np.int32))
        # relative pose correction: preserve T_cur * T_kf^-1 across the
        # mapper's adjustment of the keyframe (local BA, loop correction)
        kf = self._map_kf
        if (kf >= 0 and self._map_kf_pose0 is not None
                and self.last_pose is not None and store.kf_valid[kf]):
            delta = _relpose_delta(self._map_kf_pose0, store.kf_pose[kf])
            if delta is not None:
                self.last_pose = _apply_delta_host(self.last_pose, delta)
                if self._prev_pose is not None:
                    self._prev_pose = _apply_delta_host(self._prev_pose, delta)
                if self._pend is not None:
                    fid, pfeat, pres, pc, pe = self._pend
                    pres = pres._replace(
                        pose=_apply_delta_dev(pres.pose, self._dev(delta)))
                    self._pend = (fid, pfeat, pres, pc, pe)
        self._map_kf = -1
        self._map_kf_pose0 = None
        lc = self.local_mapper.loop_closer if self.local_mapper else None
        if lc is not None and lc.n_loops_closed > self._map_loops0:
            # loop correction moved (and rescaled) the map: the motion
            # model is stale — force a full staged re-anchor next frame
            self.velocity = None
        # the map changed under the device blocks: realign at next dispatch
        self._invalidate_device_state()

    def _apply_buffers(self):
        store = self.store
        for ids in self._buf_visible:
            rs = store.resolve_replacements(ids)
            rs = rs[(rs >= 0) & store.mp_valid[np.clip(rs, 0, None)]]
            store.mp_visible[rs] += 1
        for ids in self._buf_found:
            rs = store.resolve_replacements(ids)
            rs = rs[(rs >= 0) & store.mp_valid[np.clip(rs, 0, None)]]
            store.mp_found[rs] += 1
        self._buf_visible = []
        self._buf_found = []

    def _try_fused(self, image, frame_id: int):
        """Synchronous fused step.  Returns (feat, ok).  On ok the tracker
        state is fully updated; on failure nothing is mutated and the caller
        reuses `feat`.

        Host->device traffic per frame is the image plus the [N] crow seed:
        previous-frame geometry comes back from the previous fused call
        (TrackResult.next_geom) and the candidate block is cached on device
        between keyframes."""
        cfg = self.cfg
        store = self.store
        last_mp = self.last_mp
        has = last_mp >= 0
        bound = last_mp[has & store.mp_valid[np.where(has, last_mp, 0)]]
        if self._device_cand is None:
            with self.tracer.span("cand_upload"):
                if not self._build_cand_block(bound):
                    return None, False
        prev_geom = self._device_geom
        if prev_geom is None:
            prev_geom = self._build_prev_geom()

        with self.tracer.span("kernel"):
            feat, res = self._fused(
                self._upload_image(image), self._dev(self.last_pose),
                self._dev(self.velocity), self.last_feat, prev_geom, self._device_cand,
                self._dev(self._host_crow()))
            pose, velocity, src, n_motion, n_track, n_in = _fetch_small(res)
        if (n_motion < cfg.min_motion_matches
                or n_track < cfg.min_track_matches
                or n_in < cfg.min_localmap_matches):
            return feat, False
        self._device_geom = res.next_geom  # stays on device

        # decode match source codes -> map-point bindings
        N = cfg.n_features
        cur_mp = np.full(N, -1, np.int32)
        m1 = (src >= 0) & (src < N)
        cur_mp[m1] = last_mp[src[m1]]
        m2 = src >= N
        cur_mp[m2] = self._cand_ids[src[m2] - N]

        # bookkeeping (TrackLocalMap's IncreaseVisible/IncreaseFound)
        cand_live = self._cand_ids[self._cand_ids >= 0]
        store.mp_visible[cand_live] += 1
        found = cur_mp[cur_mp >= 0]
        store.mp_found[found] += 1
        store.mp_visible[found] += 1

        self._prev_pose = self.last_pose.copy()
        self.last_pose = np.asarray(pose)
        self.velocity = np.asarray(velocity)
        self.cur_mp = cur_mp
        self.n_inliers = n_in
        self._save_frame(feat, frame_id, tracked=True)
        self.last_mp = cur_mp.copy()
        if self._may_insert_kfs and self._need_new_kf(frame_id):
            with self.tracer.span("create_kf"):
                self._create_new_kf(feat, frame_id)
        return feat, True

    # ------------------------------------------------------------------ #
    # Initialization
    # ------------------------------------------------------------------ #
    def _try_initialize(self, feat, frame_id):
        cfg = self.cfg
        n_valid = int(feat.valid.sum())
        if self._init_feat is None:
            if n_valid > cfg.init_min_keypoints:
                self._init_feat = feat
                self._init_frame_id = frame_id
            return
        if n_valid <= cfg.init_min_keypoints:
            self._init_feat = None
            return

        f0 = self._init_feat
        # adaptive widening: on fast starts (KITTI 08's ~2.2 m/frame opening)
        # inter-frame flow exceeds the reference's 100 px window and
        # initialization can never fire; after repeated failures double the
        # window (capped 4x).  The reference C++ has no such retry — it
        # simply fails to initialize until motion slows.
        widen = min(4.0, 2.0 ** (self._init_fail_count // 20))
        with self.tracer.span("match"):
            idx, d, ok = _search_window(
                f0.desc, feat.desc, f0.uv_und, feat.uv_und, f0.valid, feat.valid,
                radius=cfg.init_search_window * widen,
                max_dist=cfg.match_th_low * 2,
                ratio=0.9, angles_a=f0.angle, angles_b=feat.angle,
                check_rotation=True,
            )
            idx_np, ok_np = _fetch(idx, ok)
            n_matches = int(ok_np.sum())
        if n_matches < cfg.init_min_matches:
            self._init_feat = None
            self._init_fail_count += 1
            return

        # gather matched pairs into fixed [N] arrays
        uv1 = f0.uv_und
        uv2 = feat.uv_und[idx]
        g = self._draws("twoview", cfg.init_ransac_iters, cfg.n_features)
        with self.tracer.span("twoview"):
            success, good, pose2, pts = _fetch(*_two_view(
                g, uv1, uv2, ok, self.K, sigma=cfg.init_sigma,
                min_triangulated=cfg.init_min_triangulated))
        if not bool(success):
            self._init_fail_count += 1
            return

        pose1 = np.zeros(7, np.float32)
        pose1[0] = 1.0

        store = self.store
        with self.tracer.span("map_build"):
            kf0 = store.add_keyframe(pose1, self._init_frame_id, f0)
            kf1 = store.add_keyframe(pose2, frame_id, feat)
            store.kf_parent[kf1] = kf0

            desc2 = store.kf_host[kf1].desc
            cur_mp = np.full(self.cfg.n_features, -1, np.int32)
            for i in np.nonzero(good)[0]:
                m = store.add_map_point(pts[i], desc2[idx_np[i]], kf0)
                store.add_observation(m, kf0, int(i))
                store.add_observation(m, kf1, int(idx_np[i]))
                cur_mp[idx_np[i]] = m

        # full BA on the initial map (GlobalBundleAdjustemnt(20), Tracking.cc:535)
        with self.tracer.span("init_ba"):
            self._initial_ba(kf0, kf1)

        # scale so median depth of KF0 = 1 (Tracking.cc:539-565)
        with self.tracer.span("rescale"):
            mps = store.local_map_points([kf0])
            if len(mps) == 0:
                return
            depths = store.mp_pos[mps][:, 2]
            med = float(np.median(depths))
            if med < 1e-6:
                self._reset()
                return
            store.mp_pos[store.mp_valid, :] /= med
            for k in (kf0, kf1):
                p = store.kf_pose[k].copy()
                p[4:] /= med
                store.set_kf_pose(k, p)  # also refreshes the kf_center table
            for m in mps:
                store.compute_distinctive_descriptor(m)
            store.update_normals_batch(np.asarray(mps, np.int64), self.scale_factors)

        self.state = OK
        self._init_fail_count = 0
        self.last_feat = feat
        self.last_pose = store.kf_pose[kf1].copy()
        self.last_mp = cur_mp
        self.last_frame_id = frame_id
        self.ref_kf = kf1
        self.last_kf_frame_id = frame_id
        self.velocity = None
        if self.local_mapper is not None:
            self.local_mapper.note_new_points(
                [int(m) for m in mps], kf1)

    def _initial_ba(self, kf0, kf1):
        prob = _assemble_ba(self.store, [kf1], [kf0],
                            self.cfg, self.inv_sigma2, device=self.device)
        if prob is None:
            return
        poses, points, chi2 = ba.bundle_adjust(
            prob.problem, self.K, n_opt=1, iters=self.cfg.global_ba_iters)
        poses, points = _fetch(poses, points)
        _write_back(self.store, prob, poses, points)

    def _reset(self):
        """Tracking::Reset parity (src/vslam/src/Tracking.cc:1268-1305): a
        bad initialization clears the MAP, the KF database and the loop
        closer — not just the tracker — so the next init starts clean.  The
        tracker is rebuilt on the same device with its generator re-seeded
        (the reference restarts its key as well)."""
        self._pend = None
        if self._map_thread is not None:
            # never clear the store under a live mapping worker
            self._map_thread.join()
            self._map_thread = None
            self._map_exc = []
        self.store.clear()
        if self.local_mapper is not None:
            self.local_mapper.recent = []
            lc = self.local_mapper.loop_closer
            if lc is not None:
                lc.db = None
                lc.kf_bow = {}
                lc.pending = []
                lc.prev_groups = []
                lc.last_loop_kf = -10**9
        tracer = self.tracer  # System-installed live tracer survives the reset
        self.__init__(self.cfg, self.K, self.extract, self.store,
                      self.local_mapper, localization_only=self.localization_only,
                      device=self.device)
        self.tracer = tracer

    # ------------------------------------------------------------------ #
    # Tracking
    # ------------------------------------------------------------------ #
    def _track(self, feat, frame_id):
        ok = False
        if self.velocity is not None:
            ok = self._track_motion_model(feat)
        if not ok:
            ok = self._track_reference_kf(feat)
        if not ok:
            self.state = LOST
            self._save_frame(feat, frame_id, tracked=False)
            self._maybe_reset_after_loss()
            return
        self._after_pose(feat, frame_id)

    def _maybe_reset_after_loss(self):
        """Reference: losing track right after initialization (<= 5 KFs in
        the map) triggers a full Reset so the system re-initializes instead
        of relocalizing against a garbage map (Tracking.cc Track() LOST
        branch).  Never in localization mode."""
        if self.localization_only:
            return
        if int(self.store.kf_valid.sum()) <= 5:
            self._reset()
            self.state = NOT_INITIALIZED

    def _after_pose(self, feat, frame_id):
        ok = self._track_local_map(feat)
        if not ok:
            self.state = LOST
            self._save_frame(feat, frame_id, tracked=False)
            self._maybe_reset_after_loss()
            return
        # velocity update
        if self.last_pose is not None and self._prev_pose is not None:
            Tc = se3.pose_unpack(self._dev(self.last_pose))
            Tl = se3.pose_unpack(self._dev(self._prev_pose))
            Rv, tv = se3.compose(*Tc, *se3.inverse(*Tl))
            self.velocity = se3.pose_pack(Rv, tv).cpu().numpy()
        self._save_frame(feat, frame_id, tracked=True)
        self.last_mp = self.cur_mp.copy()
        if self._may_insert_kfs and self._need_new_kf(frame_id):
            with self.tracer.span("create_kf"):
                self._create_new_kf(feat, frame_id)

    def _save_frame(self, feat, frame_id, tracked: bool):
        self.last_feat = feat
        self.last_frame_id = frame_id
        if not tracked:
            self.velocity = None
            self._lost_streak += 1
        else:
            self._lost_streak = 0

    # ---- motion model ------------------------------------------------- #
    def _track_motion_model(self, feat) -> bool:
        cfg = self.cfg
        pred_dev = se3.pose_retract(
            self._dev(self.last_pose),
            se3.se3_log(*se3.pose_unpack(self._dev(self.velocity))))
        self._prev_pose = self.last_pose.copy()

        # candidates: last frame's features bound to map points
        has_mp = self.last_mp >= 0
        if has_mp.sum() < 10:
            return False
        mp_ids = np.where(has_mp, self.last_mp, 0)
        pos = self.store.mp_pos[mp_ids]
        normal = self.store.mp_normal[mp_ids]
        mind = self.store.mp_min_dist[mp_ids]
        maxd = self.store.mp_max_dist[mp_ids]
        valid_a = has_mp & self.store.mp_valid[mp_ids]

        uv, pred_level, view_cos, vis = visibility.project_points(
            pred_dev, self.K, self._dev(pos), self._dev(normal),
            self._dev(mind), self._dev(maxd), self._dev(valid_a),
            self._bx1, self._by1, cfg.scale_factor, cfg.n_levels,
            min_view_cos=-1.0, x_min=self._bx0, y_min=self._by0,
        )
        lvl_scale = self._scale_dev[self.last_feat.level.to(torch.int64)]
        for radius in (cfg.search_radius_motion, cfg.search_radius_motion_wide):
            idx, d, mok = _motion_search(
                self.last_feat.desc, feat.desc, uv, feat.uv_und,
                vis, feat.valid, radius * lvl_scale, cfg.match_th_high,
                ratio=1.0, pred_level_a=self.last_feat.level,
                levels_b=feat.level, use_kernel=cfg.use_pallas_match,
            )
            idx_np, mok_np, pred = _fetch(idx, mok, pred_dev)
            n = int(mok_np.sum())
            if n >= cfg.min_motion_matches:
                break
        if n < cfg.min_motion_matches:
            return False

        cur_mp = np.full(cfg.n_features, -1, np.int32)
        cur_mp[idx_np[mok_np]] = self.last_mp[mok_np]
        return self._optimize_current(feat, cur_mp, pred, cfg.min_track_matches)

    # ---- reference KF ------------------------------------------------- #
    def _track_reference_kf(self, feat) -> bool:
        cfg = self.cfg
        if self.ref_kf < 0:
            return False
        self._prev_pose = self.last_pose.copy() if self.last_pose is not None else None
        kf_feat = self.store.kf_features[self.ref_kf]
        kf_mp = self.store.kf_mp[self.ref_kf]
        has_mp = kf_mp >= 0
        valid_a = self._dev(has_mp) & kf_feat.valid
        idx, d, mok = _search_global(
            kf_feat.desc, feat.desc, valid_a, feat.valid,
            max_dist=cfg.match_th_low * 2, ratio=0.7,
        )
        idx_np, mok_np = _fetch(idx, mok)
        if mok_np.sum() < cfg.min_refkf_matches:
            return False
        cur_mp = np.full(cfg.n_features, -1, np.int32)
        cur_mp[idx_np[mok_np]] = kf_mp[mok_np]
        start = self.last_pose if self.last_pose is not None else self.store.kf_pose[self.ref_kf]
        return self._optimize_current(feat, cur_mp, start, cfg.min_track_matches)

    def _optimize_current(self, feat, cur_mp, pose_init, min_inliers) -> bool:
        cfg = self.cfg
        has = cur_mp >= 0
        mp_ids = np.where(has, cur_mp, 0)
        pos = self.store.mp_pos[mp_ids]
        valid = has & self.store.mp_valid[mp_ids]
        inv_s2 = self._inv_sigma2_dev[feat.level.to(torch.int64)]
        pose, inl, n_in = _pose_only(
            self._dev(pose_init, torch.float32), self._dev(pos), feat.uv_und,
            inv_s2, self._dev(valid), self.K,
            rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters,
        )
        pose, inl_np, n_in = _fetch(pose, inl, n_in)
        n_in = int(n_in)
        if n_in < min_inliers:
            return False
        cur_mp[~inl_np] = -1
        self.cur_mp = cur_mp
        self.last_pose = np.asarray(pose)
        self.n_inliers = n_in
        return True

    # ---- relocalization ------------------------------------------------ #
    def _relocalize(self, feat) -> bool:
        """BoW candidates -> PnP RANSAC -> pose optimization (reference:
        KeyFrameDatabase::DetectRelocalizationCandidates + PnPsolver +
        PoseOptimization with the 50-inlier acceptance, Tracking.cc:1239).
        Without the loop closer's vocabulary and database the candidates are
        the last 5 keyframes."""
        cfg = self.cfg
        store = self.store
        lc = self.local_mapper.loop_closer if self.local_mapper else None
        cands = []
        if lc is not None and lc.vocab is not None and lc.db is not None:
            words = vocab_mod.transform(lc.vocab, feat.desc, feat.valid)
            qbow = vocab_mod.bow_vector(lc.vocab, words)
            restrict = None
            if self.localization_only and store.kf_global[:store.n_kf].any():
                # only_global_map: relocalize against the PRIOR map, never
                # against self-inserted keyframes (KeyFrameDatabase.cc:229)
                restrict = store.kf_global
            cands = lc.db.detect_reloc_candidates(
                qbow, lambda k: store.covisible_kfs(
                    int(k), min_weight=cfg.covis_weight_graph, max_n=10),
                restrict_mask=restrict)
        if not cands:
            cands = list(range(store.n_kf - 1, max(-1, store.n_kf - 6), -1))

        sigma2_dev = 1.0 / self._inv_sigma2_dev
        for c in cands[:5]:
            kf_feat = store.kf_features[c]
            kf_mp = store.kf_mp[c]
            has_mp = kf_mp >= 0
            idx, d, mok = _search_global(
                kf_feat.desc, feat.desc, self._dev(has_mp) & kf_feat.valid,
                feat.valid, max_dist=cfg.match_th_low * 2, ratio=0.75)
            idx_np, mok_np = _fetch(idx, mok)
            if mok_np.sum() < cfg.min_refkf_matches:
                continue
            # 3D-2D pairs indexed by the CURRENT frame's features
            cur_mp = np.full(cfg.n_features, -1, np.int32)
            cur_mp[idx_np[mok_np]] = kf_mp[mok_np]
            has = cur_mp >= 0
            mp_ids = np.where(has, cur_mp, 0)
            valid = has & store.mp_valid[mp_ids]
            if valid.sum() < cfg.min_refkf_matches:
                continue
            X = store.mp_pos[mp_ids]
            chi2_px = cfg.reloc_ransac_th2 * sigma2_dev[feat.level.to(torch.int64)]
            g = self._draws("pnp", cfg.reloc_ransac_iters, cfg.n_features,
                            seed=int(store.n_kf) * 131 + int(c))
            res = _ransac_pnp(
                g, self._dev(X), feat.uv_und, self._dev(valid), self.K,
                chi2_px, min_inliers=cfg.reloc_ransac_min_inliers)
            success, pose0 = _fetch(res.success, se3.pose_pack(res.R, res.t))
            if not bool(success):
                continue
            if not self._optimize_current(feat, cur_mp.copy(), pose0, 10):
                continue
            # widening by projection (Tracking.cc:1190-1240): a thin pose-opt result
            # gets a WIDER SearchByProjection against the candidate KF's map
            # points and a re-optimization — acceptance stays at 50 inliers,
            # never relaxed.
            if self.n_inliers < cfg.reloc_min_inliers:
                n_add = self._reloc_widen(feat, int(c), radius=10.0,
                                          max_dist=cfg.match_th_high)
                if n_add + self.n_inliers >= cfg.reloc_min_inliers:
                    self._optimize_current(feat, self.cur_mp, self.last_pose, 10)
                    if 30 < self.n_inliers < cfg.reloc_min_inliers:
                        # second, narrower pass (window 3, tighter distance)
                        self._reloc_widen(feat, int(c), radius=3.0,
                                          max_dist=cfg.match_th_low * 2)
                        self._optimize_current(feat, self.cur_mp,
                                               self.last_pose, 10)
            if self.n_inliers >= cfg.reloc_min_inliers:
                self._prev_pose = None
                return True
        return False

    def _search_by_projection(self, feat, mp_p, valid_a, skip_b, radius: float,
                              max_dist: float, ratio: float, min_view_cos: float):
        """``project_search`` of a padded block of map points through the
        current pose estimate into ``feat``.  Returns (idx, ok) on the
        device."""
        cfg = self.cfg
        store = self.store
        return _project_search(
            self._dev(self.last_pose), self.K,
            self._dev(store.mp_pos[mp_p]), self._dev(store.mp_normal[mp_p]),
            self._dev(store.mp_min_dist[mp_p]), self._dev(store.mp_max_dist[mp_p]),
            self._dev(valid_a), self._dev(store.mp_desc[mp_p], self._desc_dtype),
            feat.desc, feat.uv_und, feat.valid, feat.level, self._dev(skip_b),
            self._scale_dev, radius=radius, bounds=(self._bx0, self._bx1, self._by0, self._by1),
            max_dist=max_dist, ratio=ratio, min_view_cos=min_view_cos,
            scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
            use_kernel=cfg.use_pallas_match)

    def _bind_first_wins(self, cur_mp, idx_np, mok_np, mp_p) -> int:
        """Vectorized first-wins scatter (row order = candidate order, as a
        sequential loop would): keep the first candidate per feature target,
        bind only features still unmatched.  Returns the number bound."""
        rows = np.nonzero(mok_np)[0]
        f = idx_np[rows]
        first = np.zeros(len(f), bool)
        first[np.unique(f, return_index=True)[1]] = True
        sel = first & (cur_mp[f] < 0)
        cur_mp[f[sel]] = mp_p[rows[sel]]
        return int(sel.sum())

    def _reloc_widen(self, feat, kf: int, radius: float, max_dist: float) -> int:
        """Wider SearchByProjection of the candidate KF's map points through
        the current pose estimate, binding matches into ``self.cur_mp`` for
        features not already matched (the sFound-excluded re-search of
        Tracking.cc:1190-1232).  Returns the number of NEW bindings."""
        cfg = self.cfg
        store = self.store
        kf_mp = store.kf_mp[kf]
        mps = np.unique(kf_mp[kf_mp >= 0])
        mps = mps[store.mp_valid[mps]]
        already = set(self.cur_mp[self.cur_mp >= 0].tolist())
        mps = np.asarray([m for m in mps if m not in already], np.int64)
        if len(mps) == 0:
            return 0
        P = cfg.local_ba_max_points
        mps = mps[:P]
        pad = P - len(mps)
        mp_p = np.pad(mps, (0, pad), constant_values=0)
        valid_a = np.pad(np.ones(len(mps), bool), (0, pad))
        idx, mok = self._search_by_projection(feat, mp_p, valid_a, self.cur_mp >= 0, radius,
                                              max_dist, ratio=1.0, min_view_cos=-1.0)
        idx_np, mok_np = _fetch(idx, mok)
        return self._bind_first_wins(self.cur_mp, idx_np, mok_np, mp_p)

    # ---- local map ---------------------------------------------------- #
    def _track_local_map(self, feat) -> bool:
        cfg = self.cfg
        store = self.store
        cur_mp = self.cur_mp

        # local KFs: observers of current points, + their neighbours (<=80)
        obs_kfs = {}
        for m in cur_mp[cur_mp >= 0]:
            n = store.mp_n_obs[m]
            for kf in store.mp_obs_kf[m, :n]:
                obs_kfs[kf] = obs_kfs.get(kf, 0) + 1
        if not obs_kfs:
            return False
        self.ref_kf = max(obs_kfs, key=obs_kfs.get)
        local_kfs = sorted(obs_kfs, key=obs_kfs.get, reverse=True)
        for kf in list(local_kfs):
            if len(local_kfs) >= cfg.local_window_kfs:
                break
            for nb in store.covisible_kfs(int(kf), min_weight=cfg.covis_weight_graph, max_n=10):
                if nb not in obs_kfs and len(local_kfs) < cfg.local_window_kfs:
                    obs_kfs[nb] = 0
                    local_kfs.append(nb)

        mp_ids = store.local_map_points([int(k) for k in local_kfs])
        already = set(cur_mp[cur_mp >= 0].tolist())
        cand = np.array([m for m in mp_ids if m not in already], np.int32)
        if len(cand):
            store.mp_visible[cand] += 1  # coarse IncreaseVisible
            P = cfg.local_ba_max_points
            cand = cand[:P]
            pad = P - len(cand)
            cand_p = np.pad(cand, (0, pad), constant_values=0)
            valid_a = np.pad(np.ones(len(cand), bool), (0, pad))
            idx, mok = self._search_by_projection(feat, cand_p, valid_a, cur_mp >= 0,
                                                  cfg.search_radius_local, cfg.match_th_high,
                                                  ratio=0.8, min_view_cos=0.5)
            idx_np, mok_np = _fetch(idx, mok)
            self._bind_first_wins(cur_mp, idx_np, mok_np, cand_p)

        # final pose optimization with all matches
        ok = self._optimize_current(feat, cur_mp, self.last_pose, cfg.min_localmap_matches)
        if ok:
            found = self.cur_mp[self.cur_mp >= 0]
            store.mp_found[found] += 1
            store.mp_visible[found] += 1
        return ok

    # ---- keyframe policy ---------------------------------------------- #
    def _need_new_kf(self, frame_id) -> bool:
        cfg = self.cfg
        if self.n_inliers < cfg.min_match_count:
            return True
        return frame_id >= self.last_kf_frame_id + cfg.max_step_kf

    def _create_new_kf(self, feat, frame_id, async_ok: bool = False):
        store = self.store
        kf = store.add_keyframe(self.last_pose, frame_id, feat)
        for f in np.nonzero(self.cur_mp >= 0)[0]:
            store.add_observation(int(self.cur_mp[f]), kf, int(f))
        self.ref_kf = kf
        self.last_kf_frame_id = frame_id
        # the new KF's pose IS the current pose: snapshot it before the
        # asynchronous mapper starts adjusting the store
        self._ref_snapshot = (kf, self.last_pose.copy())
        self.last_mp = self.cur_mp.copy()
        if self.local_mapper is None:
            self.cur_mp = self.last_mp.copy()
            self._invalidate_device_state()
            return
        if async_ok and self.cfg.async_mapping:
            # phase A (triangulation) runs inline so the new map points
            # reach the tracker's candidate block IMMEDIATELY; the expensive
            # tail (fuse + local BA + culling + loop closing) runs in the
            # worker and overlaps the next frames' tracking
            self.cur_mp = self.last_mp.copy()
            with self.tracer.span("triangulate_sync"):
                self.local_mapper.process_phase_a(kf)
            self._rebuild_cand_after_kf()
            self._spawn_mapping(kf, phase_b_only=True)
            return
        lc = self.local_mapper.loop_closer
        loops_before = lc.n_loops_closed if lc is not None else 0
        self.local_mapper.process(kf)
        # mapping may have adjusted poses: refresh
        self.last_pose = store.kf_pose[kf].copy()
        self.last_mp = store.kf_mp[kf].copy()
        if lc is not None and lc.n_loops_closed > loops_before:
            # loop correction moved the map: the motion model is stale
            self.velocity = None
        # keep frame->mp binding fresh for the motion model
        self.cur_mp = self.last_mp.copy()
        # mapping/loop closure changed the map: device caches are stale
        self._invalidate_device_state()

    _prev_pose = None


# --------------------------------------------------------------------------- #
# Relative pose helpers (host)
# --------------------------------------------------------------------------- #
def _relpose_delta(pose_kf_before: np.ndarray, pose_kf_after: np.ndarray):
    """delta = T_k0^-1 * T_k1 (right-composition factor that carries a pose
    expressed against a keyframe's earlier pose onto its later one).
    Returns None when the adjustment is negligible."""
    R0, t0 = _kf_rt(pose_kf_before)
    R1, t1 = _kf_rt(pose_kf_after)
    Rd = R0.T @ R1
    td = R0.T @ (t1 - t0)
    ang = abs(float(np.trace(Rd)) - 3.0)
    if ang < 1e-12 and float(np.dot(td, td)) < 1e-16:
        return None
    q = _np_mat_to_quat(Rd)
    return np.concatenate([q, td]).astype(np.float32)


def _kf_rt(pose7):
    return _pose_np(pose7)


def _np_mat_to_quat(R):
    """Rotation matrix [3, 3] -> quaternion (w, x, y, z), numpy."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                         (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    if i == 1:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        return np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                         0.25 * s, (R[1, 2] + R[2, 1]) / s])
    s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
    return np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                     (R[1, 2] + R[2, 1]) / s, 0.25 * s])


def _apply_delta_host(pose7: np.ndarray, delta7: np.ndarray) -> np.ndarray:
    Ra, ta = _kf_rt(pose7)
    Rd, td = _kf_rt(delta7)
    R = Ra @ Rd
    t = Ra @ td + ta
    return np.concatenate([_np_mat_to_quat(R), t]).astype(np.float32)


def _apply_delta_dev(pose7, delta7):
    """_apply_delta_host on the device: pose7 o delta7."""
    Ra, ta = se3.pose_unpack(pose7)
    Rd, td = se3.pose_unpack(delta7)
    return se3.pose_pack(*se3.compose(Ra, ta, Rd, td))


def _remap_crow(crow, remap):
    """Carry candidate-row bindings across a block rebuild: old row -> new
    row (-1 when the point left the block, e.g. it became bound)."""
    safe = torch.clamp(crow, 0, remap.shape[0] - 1).to(torch.int64)
    return torch.where(crow >= 0, remap[safe], -1).to(torch.int32)


# --------------------------------------------------------------------------- #
# BA assembly helpers (shared with local mapping)
# --------------------------------------------------------------------------- #
class AssembledBA:
    def __init__(self, problem, opt_kfs, fixed_kfs, mp_ids, obs_map,
                 n_opt=None):
        self.problem = problem
        self.opt_kfs = opt_kfs
        self.fixed_kfs = fixed_kfs
        self.mp_ids = mp_ids
        self.obs_map = obs_map  # list of (mp, kf, feat) per obs row
        # n_opt to pass to bundle_adjust (>= len(opt_kfs) when the camera
        # axis is bucketed; pad cameras carry no observations)
        self.n_opt = len(opt_kfs) if n_opt is None else n_opt


def _bucket(n: int, cap: int, lo: int = 1024) -> int:
    """Smallest power-of-two >= n, clamped to [lo, cap] — BA problems are
    padded to a handful of bucketed shapes instead of always paying the
    max-capacity cost (a typical window has ~1/4 of the cap's points/obs)."""
    b = lo
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def _assemble_ba(store: MapStore, opt_kfs, fixed_kfs, cfg: SlamConfig, inv_sigma2_lut,
                 max_points=None, max_obs=None, bucket_cams=False, device="cuda"):
    """Build a fixed-shape BAProblem on ``device`` from the store for the
    given KF window.

    bucket_cams: pad the camera axes (n_opt and total cameras) up to
    power-of-two buckets with observation-free pad cameras, as the reference
    does to keep its set of compiled shapes small.  Pad cameras are
    numerically inert: no observation references them, so their
    reduced-system block is pure LM damping and their update is exactly
    zero.  The bucketing is kept because the padded problem, zero-weight
    observations included, is what the reference solves."""
    max_points = max_points or cfg.local_ba_max_points
    max_obs = max_obs or cfg.local_ba_max_obs
    opt_kfs = [int(k) for k in opt_kfs]
    fixed_kfs = [int(k) for k in fixed_kfs]
    n_opt_real = len(opt_kfs)
    if bucket_cams:
        n_opt_b = _bucket(n_opt_real, cfg.local_ba_max_kfs, lo=2)
        c_cap = cfg.local_ba_max_kfs + cfg.local_ba_max_fixed
        c_real = n_opt_b + len(fixed_kfs)
        c_b = _bucket(c_real, max(c_cap, c_real), lo=4)
    else:
        n_opt_b = n_opt_real
        c_b = n_opt_real + len(fixed_kfs)
    all_kfs = opt_kfs + fixed_kfs
    kf_slot = {k: i for i, k in enumerate(opt_kfs)}
    for j, k in enumerate(fixed_kfs):
        kf_slot[k] = n_opt_b + j

    mp_ids = store.local_map_points(opt_kfs)
    mp_ids = mp_ids[:max_points]
    if len(mp_ids) == 0:
        return None
    max_points = _bucket(len(mp_ids), max_points)
    mp_ids = mp_ids[:max_points]

    # vectorized observation gather: one SoA gather + slot remap
    pt_row, kfs, feats = store.observation_rows(mp_ids)
    slot_of_kf = np.full(store.max_kfs, -1, np.int64)
    for k, i in kf_slot.items():
        slot_of_kf[k] = i
    cams = slot_of_kf[kfs]
    keep = cams >= 0
    pt_row, kfs, feats, cams = pt_row[keep], kfs[keep], feats[keep], cams[keep]
    if len(pt_row) > max_obs:
        pt_row, kfs, feats, cams = (pt_row[:max_obs], kfs[:max_obs],
                                    feats[:max_obs], cams[:max_obs])
    max_obs = _bucket(len(pt_row), max_obs, lo=4096)
    rows = list(zip(mp_ids[pt_row].tolist(), kfs.tolist(), feats.tolist()))
    n_rows = len(pt_row)

    O = max_obs
    cam_idx = np.zeros(O, np.int64)
    pt_idx = np.zeros(O, np.int64)
    uv = np.zeros((O, 2), np.float32)
    inv_s2 = np.ones(O, np.float32)
    valid = np.zeros(O, bool)
    cam_idx[:n_rows] = cams
    pt_idx[:n_rows] = pt_row
    uv[:n_rows] = store.kf_uv_t[kfs, feats]
    inv_s2[:n_rows] = np.asarray(inv_sigma2_lut)[store.kf_level_t[kfs, feats]]
    valid[:n_rows] = True

    P = max_points
    points = np.zeros((P, 3), np.float32)
    pt_valid = np.zeros(P, bool)
    points[:len(mp_ids)] = store.mp_pos[mp_ids]
    pt_valid[:len(mp_ids)] = True

    poses = np.zeros((c_b, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:n_opt_real] = store.kf_pose[np.asarray(opt_kfs)]
    poses[n_opt_real:n_opt_b] = poses[max(n_opt_real - 1, 0)]  # inert opt pads
    if fixed_kfs:
        poses[n_opt_b:n_opt_b + len(fixed_kfs)] = store.kf_pose[np.asarray(fixed_kfs)]
    k_max = min(_bucket(len(all_kfs), store.max_obs, lo=8), store.max_obs)
    pt_obs = ba.build_pt_obs(pt_idx, valid, P, k_max)

    def up(a):
        return torch.as_tensor(a).to(device)

    obs = ba.Obs(cam_idx=up(cam_idx), pt_idx=up(pt_idx),
                 uv=up(uv), inv_sigma2=up(inv_s2), valid=up(valid))
    problem = ba.BAProblem(poses7=up(poses), points=up(points),
                           pt_valid=up(pt_valid), obs=obs,
                           pt_obs=up(pt_obs.astype(np.int64)))
    return AssembledBA(problem, opt_kfs, fixed_kfs, mp_ids, rows, n_opt=n_opt_b)


def _write_back(store: MapStore, asm: AssembledBA, poses, points, outliers=None):
    for i, k in enumerate(asm.opt_kfs):
        store.set_kf_pose(k, poses[i])
    store.mp_pos[asm.mp_ids] = points[:len(asm.mp_ids)]
    if outliers is not None:
        # only walk the outlier rows (the full obs table is up to 32k rows;
        # outliers are typically a few dozen)
        n_rows = len(asm.obs_map)
        for o in np.nonzero(np.asarray(outliers[:n_rows]))[0]:
            m, kf, feat = asm.obs_map[o]
            store.erase_observation(m, kf)
