"""Struct-of-arrays map store: keyframes, map points, observations.

Copy of ``asdslam_tpu/mapping/map_store.py`` (numpy; the port imports
nothing of the JAX package).  It replaces the pointer-graph
Map/KeyFrame/MapPoint object model of the reference
(src/vslam/src/{Map,KeyFrame,MapPoint}.cc) with flat arrays of static
capacity + validity masks.  The store lives on the HOST (numpy): it is
irregular bookkeeping, not compute; every device function receives
fixed-shape slices assembled from it.  Per-keyframe feature tensors
(descriptors, keypoints) stay on the DEVICE as the FrameFeatures produced at
extraction time, so matching/BA never re-uploads them.

The changes from the original: how ``add_keyframe`` fetches the features
(torch tensors here); ``from_arrays``, which fills a store from the numpy
arrays of another, for tests that start both packages from one state; and
``compute_distinctive_descriptors``, the one-point refresh over a block of
points with the same bits.

Key relations:
- kf_mp[k, i]  = map-point id observed by feature i of keyframe k (-1 = none)
  (the inverse of MapPoint::mObservations)
- mp_obs[m, :] = packed (kf_id, feat_idx) observation list per point
- covisibility weights are derived on demand from shared observations
  (KeyFrame::UpdateConnections, KeyFrame.cc:533+); no cached adjacency.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

_DESC_CHUNK = 1 << 22  # float32 elements of one chunk's pairwise differences


class HostFeat(NamedTuple):
    """Host (numpy) mirror of a keyframe's FrameFeatures, fetched ONCE at
    keyframe insertion.  All irregular bookkeeping (descriptor medians, BA
    assembly, culling) reads these instead of indexing the device pytree —
    per-element device reads each cost a synchronisation."""

    uv_und: np.ndarray  # [N, 2]
    level: np.ndarray   # [N]
    desc: np.ndarray    # [N, D]
    valid: np.ndarray   # [N]


class MapStore:
    def __init__(self, max_kfs: int, max_pts: int, n_feat: int, max_obs: int = 32):
        self.max_kfs = max_kfs
        self.max_pts = max_pts
        self.n_feat = n_feat
        self.max_obs = max_obs

        # keyframes
        self.n_kf = 0
        self.kf_pose = np.zeros((max_kfs, 7), np.float32)  # T_cw packed (q, t)
        self.kf_pose[:, 0] = 1.0
        self.kf_frame_id = np.full(max_kfs, -1, np.int64)
        self.kf_valid = np.zeros(max_kfs, bool)
        self.kf_mp = np.full((max_kfs, n_feat), -1, np.int32)
        self.kf_features: List[object] = []  # device FrameFeatures per KF
        self.kf_host: List[HostFeat] = []    # host numpy mirrors (same index)
        # dense lookup tables for vectorized bookkeeping
        self.kf_level_t = np.zeros((max_kfs, n_feat), np.int32)
        self.kf_uv_t = np.zeros((max_kfs, n_feat, 2), np.float32)
        self.kf_center = np.zeros((max_kfs, 3), np.float32)  # camera centres
        self.kf_parent = np.full(max_kfs, -1, np.int32)  # spanning tree
        # culled-KF bookkeeping for frame-trajectory recomposition
        # (System::SaveTrajectoryTUM walks Tcp links for bad KFs,
        # src/vslam/src/System.cc:523-528): parent at cull time + relative
        # pose T_kf * T_parent^-1 captured at cull time
        self.kf_cull_parent = np.full(max_kfs, -1, np.int32)
        self.kf_cull_rel = np.zeros((max_kfs, 7), np.float32)
        self.kf_cull_rel[:, 0] = 1.0
        # provenance: True = entity from a LOADED prior map (the reference's
        # GlobalMapFlag, KeyFrame.h:142-143) — KeyFrameDatabase filters
        # reloc/loop candidates on it in localization mode
        # (KeyFrameDatabase.cc:146,229)
        self.kf_global = np.zeros(max_kfs, bool)
        self.loop_edges: List[tuple] = []  # (kf_a, kf_b) accepted loop pairs

        # map points
        self.n_mp = 0
        self.mp_pos = np.zeros((max_pts, 3), np.float32)
        self.mp_desc = np.zeros((max_pts, 128), np.float32)
        self.mp_normal = np.zeros((max_pts, 3), np.float32)
        self.mp_min_dist = np.zeros(max_pts, np.float32)
        self.mp_max_dist = np.zeros(max_pts, np.float32)
        self.mp_valid = np.zeros(max_pts, bool)
        self.mp_first_kf = np.full(max_pts, -1, np.int32)
        self.mp_found = np.zeros(max_pts, np.int32)    # MapPoint::IncreaseFound
        self.mp_visible = np.zeros(max_pts, np.int32)  # MapPoint::IncreaseVisible
        self.mp_obs_kf = np.full((max_pts, max_obs), -1, np.int32)
        self.mp_obs_feat = np.full((max_pts, max_obs), -1, np.int32)
        self.mp_n_obs = np.zeros(max_pts, np.int32)
        # MapPoint::Replace leaves dangling ids in external bindings (the
        # tracker's last_mp during asynchronous mapping); this table lets
        # them be resolved to the surviving point (MapPoint::GetReplaced)
        self.mp_replaced_by = np.full(max_pts, -1, np.int32)
        self.mp_global = np.zeros(max_pts, bool)  # prior-map provenance

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def clear(self):
        """Reset to the empty state — Tracking::Reset parity
        (src/vslam/src/Tracking.cc:1268-1305 clears map + KF database + ids
        on bad initialization).  Capacities are kept at their current size."""
        self.__init__(self.max_kfs, self.max_pts, self.n_feat, self.max_obs)

    def _grow_keyframes(self):
        """Double the keyframe capacity (host numpy arrays only; device
        functions consume fixed-size windows assembled from the store)."""
        old = self.max_kfs
        new = old * 2

        def g(a, fill):
            out = np.full((new,) + a.shape[1:], fill, a.dtype)
            out[:old] = a
            return out

        self.kf_pose = g(self.kf_pose, 0.0)
        self.kf_pose[old:, 0] = 1.0
        self.kf_frame_id = g(self.kf_frame_id, -1)
        self.kf_valid = g(self.kf_valid, False)
        self.kf_mp = g(self.kf_mp, -1)
        self.kf_level_t = g(self.kf_level_t, 0)
        self.kf_uv_t = g(self.kf_uv_t, 0.0)
        self.kf_center = g(self.kf_center, 0.0)
        self.kf_parent = g(self.kf_parent, -1)
        self.kf_cull_parent = g(self.kf_cull_parent, -1)
        self.kf_cull_rel = g(self.kf_cull_rel, 0.0)
        self.kf_cull_rel[old:, 0] = 1.0
        self.kf_global = g(self.kf_global, False)
        self.max_kfs = new

    def _grow_map_points(self):
        old = self.max_pts
        new = old * 2

        def g(a, fill):
            out = np.full((new,) + a.shape[1:], fill, a.dtype)
            out[:old] = a
            return out

        self.mp_pos = g(self.mp_pos, 0.0)
        self.mp_desc = g(self.mp_desc, 0.0)
        self.mp_normal = g(self.mp_normal, 0.0)
        self.mp_min_dist = g(self.mp_min_dist, 0.0)
        self.mp_max_dist = g(self.mp_max_dist, 0.0)
        self.mp_valid = g(self.mp_valid, False)
        self.mp_first_kf = g(self.mp_first_kf, -1)
        self.mp_found = g(self.mp_found, 0)
        self.mp_visible = g(self.mp_visible, 0)
        self.mp_obs_kf = g(self.mp_obs_kf, -1)
        self.mp_obs_feat = g(self.mp_obs_feat, -1)
        self.mp_n_obs = g(self.mp_n_obs, 0)
        self.mp_replaced_by = g(self.mp_replaced_by, -1)
        self.mp_global = g(self.mp_global, False)
        self.max_pts = new

    # every array attribute of the store, and its scalar counters
    ARRAYS = ("kf_pose", "kf_frame_id", "kf_valid", "kf_mp", "kf_level_t", "kf_uv_t",
              "kf_center", "kf_parent", "kf_cull_parent", "kf_cull_rel", "kf_global",
              "mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_valid",
              "mp_first_kf", "mp_found", "mp_visible", "mp_obs_kf", "mp_obs_feat",
              "mp_n_obs", "mp_replaced_by", "mp_global")

    @classmethod
    def from_arrays(cls, arrays, n_kf: int, n_mp: int, kf_host, kf_features,
                    loop_edges=()):
        """A store holding copies of ``arrays`` (a mapping with every name of
        ``ARRAYS``, as numpy), e.g. those of a store of the JAX package.

        kf_host: per keyframe a (uv_und, level, desc, valid) tuple of numpy
        arrays; kf_features: per keyframe the device-side FrameFeatures."""
        max_kfs, n_feat = arrays["kf_mp"].shape
        max_pts, max_obs = arrays["mp_obs_kf"].shape
        store = cls(max_kfs, max_pts, n_feat, max_obs)
        for name in cls.ARRAYS:
            ref = getattr(store, name)
            a = np.array(arrays[name], dtype=ref.dtype)
            if a.shape != ref.shape:
                raise ValueError(f"{name}: shape {a.shape}, expected {ref.shape}")
            setattr(store, name, a)
        store.n_kf, store.n_mp = int(n_kf), int(n_mp)
        store.kf_host = [HostFeat(np.array(u, np.float32), np.array(l, np.int32),
                                  np.array(d, np.float32), np.array(v, bool))
                         for u, l, d, v in kf_host]
        store.kf_features = list(kf_features)
        store.loop_edges = list(loop_edges)
        return store

    # ------------------------------------------------------------------ #
    # Keyframes
    # ------------------------------------------------------------------ #
    def add_keyframe(self, pose7: np.ndarray, frame_id: int, features) -> int:
        k = self.n_kf
        if k >= self.max_kfs:
            self._grow_keyframes()
        self.kf_pose[k] = np.asarray(pose7, np.float32)
        self.kf_frame_id[k] = frame_id
        self.kf_valid[k] = True
        self.kf_features.append(features)
        # The host mirror's descriptors are rounded through bf16, as the
        # original's download is: unit-norm descriptors lose ~1e-2 absolute
        # worst case, far below the match thresholds, and the matchers
        # multiply them as bf16 anyway.  One fetch per field, after the
        # last of them is queued.
        desc_r = features.desc.to(torch.bfloat16).to(torch.float32)
        self.kf_host.append(HostFeat(
            uv_und=features.uv_und.cpu().numpy().astype(np.float32),
            level=features.level.cpu().numpy().astype(np.int32),
            desc=desc_r.cpu().numpy(),
            valid=features.valid.cpu().numpy().astype(bool)))
        self.kf_level_t[k] = self.kf_host[k].level
        self.kf_uv_t[k] = self.kf_host[k].uv_und
        R, t = _pose_np(self.kf_pose[k])
        self.kf_center[k] = -R.T @ t
        self.n_kf += 1
        return k

    def set_kf_pose(self, k: int, pose7: np.ndarray):
        self.kf_pose[k] = np.asarray(pose7, np.float32)
        R, t = _pose_np(self.kf_pose[k])
        self.kf_center[k] = -R.T @ t

    # ------------------------------------------------------------------ #
    # Map points
    # ------------------------------------------------------------------ #
    def add_map_point(self, pos, desc, first_kf: int) -> int:
        m = self.n_mp
        if m >= self.max_pts:
            self._grow_map_points()
        self.mp_pos[m] = np.asarray(pos, np.float32)
        self.mp_desc[m] = np.asarray(desc, np.float32)
        self.mp_valid[m] = True
        self.mp_first_kf[m] = first_kf
        self.mp_found[m] = 1
        self.mp_visible[m] = 1
        self.n_mp += 1
        return m

    def _grow_obs(self):
        """Double the per-point observation capacity (axis 1)."""
        def g(a):
            out = np.full((a.shape[0], a.shape[1] * 2), -1, a.dtype)
            out[:, :a.shape[1]] = a
            return out

        self.mp_obs_kf = g(self.mp_obs_kf)
        self.mp_obs_feat = g(self.mp_obs_feat)
        self.max_obs *= 2

    def add_observation(self, mp: int, kf: int, feat: int):
        if not self.mp_valid[mp]:
            return
        n = self.mp_n_obs[mp]
        if n >= self.max_obs:
            self._grow_obs()
        # no duplicate obs of the same KF
        if (self.mp_obs_kf[mp, :n] == kf).any():
            return
        self.mp_obs_kf[mp, n] = kf
        self.mp_obs_feat[mp, n] = feat
        self.mp_n_obs[mp] = n + 1
        self.kf_mp[kf, feat] = mp

    def erase_observation(self, mp: int, kf: int):
        n = self.mp_n_obs[mp]
        sel = self.mp_obs_kf[mp, :n] == kf
        if not sel.any():
            return
        i = int(np.argmax(sel))
        feat = self.mp_obs_feat[mp, i]
        if self.kf_mp[kf, feat] == mp:
            self.kf_mp[kf, feat] = -1
        self.mp_obs_kf[mp, i:n - 1] = self.mp_obs_kf[mp, i + 1:n]
        self.mp_obs_feat[mp, i:n - 1] = self.mp_obs_feat[mp, i + 1:n]
        self.mp_obs_kf[mp, n - 1] = -1
        self.mp_obs_feat[mp, n - 1] = -1
        self.mp_n_obs[mp] = n - 1
        if self.mp_n_obs[mp] <= 1 and self.mp_first_kf[mp] != kf:
            # degenerate point: keep but it becomes cull candidate
            pass

    def erase_map_point(self, mp: int):
        n = self.mp_n_obs[mp]
        for i in range(n):
            kf = self.mp_obs_kf[mp, i]
            feat = self.mp_obs_feat[mp, i]
            if kf >= 0 and self.kf_mp[kf, feat] == mp:
                self.kf_mp[kf, feat] = -1
        self.mp_obs_kf[mp, :] = -1
        self.mp_obs_feat[mp, :] = -1
        self.mp_n_obs[mp] = 0
        self.mp_valid[mp] = False

    def replace_map_point(self, old: int, new: int):
        """MapPoint::Replace — rebind all observations of `old` to `new`."""
        if old == new:
            return
        n = self.mp_n_obs[old]
        for i in range(int(n)):
            kf = int(self.mp_obs_kf[old, i])
            feat = int(self.mp_obs_feat[old, i])
            if kf < 0:
                continue
            if (self.mp_obs_kf[new, :self.mp_n_obs[new]] == kf).any():
                # new already seen in this KF: drop the old binding
                if self.kf_mp[kf, feat] == old:
                    self.kf_mp[kf, feat] = -1
            else:
                if self.mp_n_obs[new] >= self.max_obs:
                    self._grow_obs()
                self.mp_obs_kf[new, self.mp_n_obs[new]] = kf
                self.mp_obs_feat[new, self.mp_n_obs[new]] = feat
                self.mp_n_obs[new] += 1
                self.kf_mp[kf, feat] = new
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        self.mp_obs_kf[old, :] = -1
        self.mp_obs_feat[old, :] = -1
        self.mp_n_obs[old] = 0
        self.mp_valid[old] = False
        self.mp_replaced_by[old] = new

    def resolve_replacements(self, ids: np.ndarray) -> np.ndarray:
        """Follow replace_map_point chains: ids (-1 allowed) -> surviving
        point ids (or the original id if never replaced).  Vectorized; the
        chain depth is bounded by the number of merges since the binding was
        taken (typically 0-2)."""
        out = np.asarray(ids).copy()
        for _ in range(8):
            has = out >= 0
            nxt = np.where(has, self.mp_replaced_by[np.where(has, out, 0)], -1)
            step = nxt >= 0
            if not step.any():
                break
            out = np.where(step, nxt, out)
        return out

    # ------------------------------------------------------------------ #
    # Covisibility
    # ------------------------------------------------------------------ #
    def covisibility_weights(self, kf: int) -> Dict[int, int]:
        """Shared-observation counts between `kf` and every other KF
        (KeyFrame::UpdateConnections semantics)."""
        mps = self.kf_mp[kf]
        mps = mps[mps >= 0]
        if len(mps) == 0:
            return {}
        obs_kfs = self.mp_obs_kf[mps]  # [n, max_obs]
        flat = obs_kfs[obs_kfs >= 0]
        flat = flat[flat != kf]
        if len(flat) == 0:
            return {}
        ids, counts = np.unique(flat, return_counts=True)
        return dict(zip(ids.tolist(), counts.tolist()))

    def covisible_kfs(self, kf: int, min_weight: int = 15, max_n: Optional[int] = None) -> List[int]:
        w = self.covisibility_weights(kf)
        items = sorted(((c, k) for k, c in w.items() if c >= min_weight), reverse=True)
        out = [k for _, k in items]
        return out[:max_n] if max_n else out

    # ------------------------------------------------------------------ #
    # Queries for kernel assembly
    # ------------------------------------------------------------------ #
    def observation_rows(self, mp_ids: np.ndarray):
        """Vectorized observation table for a block of map points: returns
        (pt_row, kf, feat) arrays in point-major order, where pt_row indexes
        into mp_ids.  One gather over the SoA store — replaces per-point
        Python loops in BA assembly."""
        mp_ids = np.asarray(mp_ids, np.int64)
        n = self.mp_n_obs[mp_ids]                       # [M]
        O = self.max_obs
        mask = np.arange(O)[None, :] < n[:, None]       # [M, O]
        pt_row = np.broadcast_to(
            np.arange(len(mp_ids))[:, None], mask.shape)[mask]
        kfs = self.mp_obs_kf[mp_ids][mask]
        feats = self.mp_obs_feat[mp_ids][mask]
        return pt_row.astype(np.int64), kfs.astype(np.int64), feats.astype(np.int64)

    def local_map_points(self, kf_ids: List[int]) -> np.ndarray:
        """Unique valid map-point ids observed by the given KFs."""
        if not kf_ids:
            return np.zeros(0, np.int32)
        mps = self.kf_mp[np.asarray(kf_ids)]
        mps = np.unique(mps[mps >= 0])
        return mps[self.mp_valid[mps]]

    def compute_distinctive_descriptor(self, mp: int):
        """Min-median-distance descriptor among observations
        (MapPoint::ComputeDistinctiveDescriptors, MapPoint.cc:271-340)."""
        n = int(self.mp_n_obs[mp])
        if n == 0:
            return
        kfs = self.mp_obs_kf[mp, :n]
        feats = self.mp_obs_feat[mp, :n]
        D = np.stack([self.kf_host[kf].desc[feat]
                      for kf, feat in zip(kfs, feats)])
        d2 = ((D[:, None, :] - D[None, :, :]) ** 2).sum(-1)
        med = np.median(d2, axis=1)
        self.mp_desc[mp] = D[int(np.argmin(med))]

    def compute_distinctive_descriptors(self, mps):
        """``compute_distinctive_descriptor`` of every point of ``mps``, without
        a Python loop over the points: the points of one observation count
        at a time, in chunks, each row reduced as the one-point version
        reduces it, so every descriptor is the same bits."""
        mps = np.asarray(mps, np.int64)
        n_obs = self.mp_n_obs[mps]
        for n in np.unique(n_obs[n_obs > 0]):
            group = mps[n_obs == n]
            kfs = self.mp_obs_kf[group, :n]
            feats = self.mp_obs_feat[group, :n]
            first = self.kf_host[int(kfs[0, 0])].desc  # every keyframe's: [n_feat, D] float32
            D = np.empty(kfs.shape + first.shape[1:], first.dtype)
            for k in np.unique(kfs):
                at = kfs == k
                D[at] = self.kf_host[k].desc[feats[at]]
            step = max(1, _DESC_CHUNK // (n * n * D.shape[-1]))
            for s in range(0, len(group), step):
                d = D[s:s + step]
                d2 = ((d[:, :, None, :] - d[:, None, :, :]) ** 2).sum(-1)
                best = np.argmin(np.median(d2, axis=2), axis=1)
                self.mp_desc[group[s:s + step]] = d[np.arange(len(d)), best]

    def update_normal_and_depth(self, mp: int, scale_factors, level_of_obs=None):
        """MapPoint::UpdateNormalAndDepth: mean viewing direction + scale
        invariance distance range."""
        self.update_normals_batch(np.array([mp]), scale_factors)

    def update_normals_batch(self, mps: np.ndarray, scale_factors):
        """Vectorized UpdateNormalAndDepth over a block of map points, using
        the kf_center / kf_level_t lookup tables (no per-observation loops)."""
        mps = np.asarray(mps, np.int64)
        mps = mps[self.mp_n_obs[mps] > 0]
        if len(mps) == 0:
            return
        obs_kf = self.mp_obs_kf[mps]                     # [M, O]
        has = obs_kf >= 0
        safe_kf = np.where(has, obs_kf, 0)
        pos = self.mp_pos[mps]                           # [M, 3]
        v = pos[:, None, :] - self.kf_center[safe_kf]    # [M, O, 3]
        nv = np.linalg.norm(v, axis=2)
        ok = has & (nv > 1e-9)
        dirs = np.where(ok[:, :, None], v / np.maximum(nv, 1e-12)[:, :, None], 0.0)
        cnt = np.maximum(ok.sum(1), 1)
        self.mp_normal[mps] = dirs.sum(1) / cnt[:, None]
        # reference KF = first observation
        kf0 = obs_kf[:, 0]
        feat0 = self.mp_obs_feat[mps, 0]
        dist = np.linalg.norm(pos - self.kf_center[kf0], axis=1)
        level = self.kf_level_t[kf0, feat0]
        sf = np.asarray(scale_factors)
        self.mp_max_dist[mps] = dist * sf[level]
        self.mp_min_dist[mps] = self.mp_max_dist[mps] / sf[len(sf) - 1]


def _pose_np_batch(pose7s: np.ndarray):
    """Packed poses [K, 7] -> (R [K, 3, 3], t [K, 3]) in numpy."""
    q = pose7s[:, :4] / np.linalg.norm(pose7s[:, :4], axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1).astype(np.float32)
    return R, pose7s[:, 4:7].astype(np.float32)


def _mat_to_quat_np_batch(R: np.ndarray):
    """Rotation matrices [K, 3, 3] -> quaternions [K, 4] (w, x, y, z),
    numerically robust branch selection, fully vectorized."""
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions, pick the one with the largest pivot
    qs = np.empty((R.shape[0], 4, 4), R.dtype)
    s0 = np.sqrt(np.maximum(tr + 1.0, 1e-12)) * 2
    qs[:, 0] = np.stack([0.25 * s0, (R[:, 2, 1] - R[:, 1, 2]) / s0,
                         (R[:, 0, 2] - R[:, 2, 0]) / s0,
                         (R[:, 1, 0] - R[:, 0, 1]) / s0], -1)
    s1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2
    qs[:, 1] = np.stack([(R[:, 2, 1] - R[:, 1, 2]) / s1, 0.25 * s1,
                         (R[:, 0, 1] + R[:, 1, 0]) / s1,
                         (R[:, 0, 2] + R[:, 2, 0]) / s1], -1)
    s2 = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 1e-12)) * 2
    qs[:, 2] = np.stack([(R[:, 0, 2] - R[:, 2, 0]) / s2,
                         (R[:, 0, 1] + R[:, 1, 0]) / s2, 0.25 * s2,
                         (R[:, 1, 2] + R[:, 2, 1]) / s2], -1)
    s3 = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 1e-12)) * 2
    qs[:, 3] = np.stack([(R[:, 1, 0] - R[:, 0, 1]) / s3,
                         (R[:, 0, 2] + R[:, 2, 0]) / s3,
                         (R[:, 1, 2] + R[:, 2, 1]) / s3, 0.25 * s3], -1)
    pivots = np.stack([tr, m00, m11, m22], -1)
    # prefer the trace branch when it is clearly positive (matches the
    # scalar helper); otherwise the largest diagonal
    choice = np.where(tr > 0, 0, 1 + np.argmax(pivots[:, 1:], axis=1))
    q = qs[np.arange(len(R)), choice]
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pose_np(pose7: np.ndarray):
    """Packed pose -> (R, t) in numpy."""
    w, x, y, z = pose7[:4] / np.linalg.norm(pose7[:4])
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return R, pose7[4:7].astype(np.float32)
