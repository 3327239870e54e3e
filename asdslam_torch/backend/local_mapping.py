"""Local mapping: the synchronous per-keyframe back-end pass.

Port of ``asdslam_tpu/backend/local_mapping.py``: numpy bookkeeping on the
store around three device calls (triangulate_neighbors, fuse_pairs,
bundle_adjust), each fetched once, then the loop closer when there is one.
The first two are module-level ``graphs.captured`` callables; on the card
they take the reference's fixed shapes (``triangulation_neighbors`` slots,
``FUSE_PAIRS`` pairs, the point axis bucketed pow2 from 256), so a
keyframe replays one of at most five graphs; on the CPU only the live
slots are evaluated.

Mirrors LocalMapping::DoMapping (src/vslam/src/LocalMapping.cc:59-113), run
after keyframe insertion: inline in synchronous mode, as the reference does
(it is single-threaded), or with phase B in the tracker's mapping worker:

1. ProcessNewKeyFrame  — descriptor/normal refresh for associated points
2. MapPointCulling     — found/visible < 0.25, or too few observations
   (LocalMapping.cc:261-297)
3. CreateNewMapPoints  — epipolar-constrained matching against the best
   covisible KFs + midpoint triangulation + cheirality/parallax/reproj/
   scale checks (299-556)
4. SearchInNeighbors   — two-way projection fuse with neighbours (557-656)
5. Local BA            — Schur-complement bundle adjustment over the
   covisibility window (Optimizer.cc:415-735) with chi2 outlier pruning
6. (KeyFrameCulling of >=90%-redundant KFs — LocalMapping.cc:739+)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from asdslam_torch.backend import ba, mapping_kernels
from asdslam_torch.config import SlamConfig
from asdslam_torch.mapping.map_store import MapStore, _mat_to_quat_np_batch, _pose_np
from asdslam_torch.utils import graphs
from asdslam_torch.utils.tracing import Tracer

FUSE_PAIRS = 2 * 10  # the fuse's pair capacity (10 neighbours, both directions)

# the two device functions of a keyframe's pass, each captured (the
# reference jits each, mapping_kernels.py:26 and :80)
_triangulate = graphs.captured(mapping_kernels.triangulate_neighbors, "triangulate_neighbors")
_fuse = graphs.captured(mapping_kernels.fuse_pairs, "fuse_pairs")


def pad_triangulation_slots(feats, nb_free, nb_R, nb_t, Q: int):
    """The live neighbour slots (features, free masks [L, N], poses [L, 3, 3]
    and [L, 3]) padded to Q slots as the reference pads them
    (local_mapping.py:156-166): the first neighbour's features, nothing
    free, the identity pose.  A padded slot matches nothing: its result is
    -1 throughout."""
    pad = Q - len(feats)
    n = nb_free.shape[1]
    return (list(feats) + [feats[0]] * pad,
            np.concatenate([nb_free, np.zeros((pad, n), bool)]),
            np.concatenate([nb_R, np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3))]),
            np.concatenate([nb_t, np.zeros((pad, 3), np.float32)]))


class LocalMapper:
    def __init__(self, cfg: SlamConfig, K, store: MapStore, loop_closer=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.store = store
        self.loop_closer = loop_closer
        self.inv_sigma2 = np.asarray(cfg.inv_level_sigma2, np.float32)
        self.scale_factors = np.asarray(cfg.scale_factors, np.float32)
        self._desc_dtype = torch.bfloat16 if cfg.desc_upload_bf16 else torch.float32
        self.recent: List[Tuple[int, int]] = []  # (mp, created_at_kf)
        self.tracer = Tracer(enabled=False)  # System installs a live one
        # what the last pass did, for checks and reports
        self.last_pass = {}

    def _dev(self, x, dtype=None):
        t = torch.as_tensor(np.ascontiguousarray(x)).to(self.device)
        return t if dtype is None else t.to(dtype)

    def note_new_points(self, mps: List[int], kf: int):
        self.recent.extend((m, kf) for m in mps)

    # ------------------------------------------------------------------ #
    def process(self, kf: int):
        self.process_phase_a(kf)
        self.process_phase_b(kf)

    def process_phase_a(self, kf: int):
        """Association refresh + point culling + triangulation — the part of
        DoMapping whose OUTPUT the tracker needs immediately (new map points
        feed the next frames' local-map search).  It neither moves poses nor
        merges points."""
        self.last_pass = {"kf": kf, "new_points": 0, "fuse_pairs": 0, "local_ba": None}
        tr = self.tracer
        with tr.span("mapping_a"):
            with tr.span("process_kf"):
                self._process_new_keyframe(kf)
            self._cull_map_points(kf)
            with tr.span("triangulate"):
                self._create_new_map_points(kf)

    def process_phase_b(self, kf: int):
        """Neighbor fusion + local BA + keyframe culling + loop closing —
        the expensive tail of DoMapping, safe to overlap with tracking (the
        tracker re-anchors to the adjusted map at the deterministic join)."""
        store = self.store
        tr = self.tracer
        with tr.span("mapping"):
            with tr.span("fuse"):
                self._fuse_neighbors(kf)
            if store.n_kf > 2:
                with tr.span("local_ba"):
                    self._local_ba(kf)
            with tr.span("cull_kfs"):
                self._cull_keyframes(kf)
        if self.loop_closer is not None:
            with tr.span("loop_closing"):
                self.loop_closer.process(kf)

    # ------------------------------------------------------------------ #
    def _process_new_keyframe(self, kf: int):
        store = self.store
        mps = store.kf_mp[kf]
        uniq = np.unique(mps[mps >= 0])
        for m in uniq:
            store.compute_distinctive_descriptor(int(m))
        store.update_normals_batch(uniq, self.scale_factors)
        # spanning-tree parent: strongest covisible earlier KF (the
        # reference's ChangeParent on first UpdateConnections)
        if store.kf_parent[kf] < 0 and kf > 0:
            w = store.covisibility_weights(kf)
            earlier = {k: c for k, c in w.items() if k < kf}
            if earlier:
                store.kf_parent[kf] = max(earlier, key=earlier.get)

    def _cull_map_points(self, kf: int):
        store = self.store
        keep = []
        for m, born in self.recent:
            if not store.mp_valid[m]:
                continue
            ratio = store.mp_found[m] / max(1, store.mp_visible[m])
            age = kf - born
            if ratio < self.cfg.mp_cull_min_found_ratio:
                store.erase_map_point(m)
            elif age >= 2 and store.mp_n_obs[m] <= self.cfg.mp_cull_min_obs:
                store.erase_map_point(m)
            elif age >= 3:
                pass  # graduated
            else:
                keep.append((m, born))
        self.recent = keep

    # ------------------------------------------------------------------ #
    def _create_new_map_points(self, kf1: int):
        """All neighbours evaluated in one call
        (mapping_kernels.triangulate_neighbors) and fetched once; the host
        applies the verdicts sequentially in neighbour order like the
        reference."""
        cfg = self.cfg
        store = self.store
        neighbors = store.covisible_kfs(kf1, min_weight=cfg.covis_weight_graph,
                                        max_n=cfg.triangulation_neighbors)
        if not neighbors:
            return
        f1 = store.kf_features[kf1]
        h1 = store.kf_host[kf1]
        R1, t1 = _pose_np(store.kf_pose[kf1])
        c1 = -R1.T @ t1
        K_np = self.K.cpu().numpy()
        fmean = 0.5 * float(K_np[0, 0] + K_np[1, 1])

        # median scene depth for the baseline gate (host-side)
        mps1 = store.kf_mp[kf1]
        mps1 = mps1[mps1 >= 0]
        if len(mps1) == 0:
            return
        depths = (store.mp_pos[mps1] @ R1[2]) + t1[2]
        median_depth = float(np.median(depths[depths > 0])) if (depths > 0).any() else 1.0

        keep = []
        for kf2 in neighbors:
            R2, t2 = _pose_np(store.kf_pose[kf2])
            baseline = float(np.linalg.norm((-R2.T @ t2) - c1))
            if baseline / max(median_depth, 1e-6) >= cfg.min_baseline_depth_ratio:
                keep.append(int(kf2))
        if not keep:
            return

        keep = keep[:cfg.triangulation_neighbors]
        with self.tracer.span("upload"):
            feats = [store.kf_features[k] for k in keep]
            nb_free = np.stack([(store.kf_mp[k] < 0) & store.kf_host[k].valid
                                for k in keep])
            nb_R = np.stack([_pose_np(store.kf_pose[k])[0] for k in keep])
            nb_t = np.stack([_pose_np(store.kf_pose[k])[1] for k in keep])
            if graphs.graph_path(f1.desc):
                # a graph takes the reference's fixed slot count, so that
                # every keyframe replays one graph; elsewhere only the live
                # slots are evaluated
                feats, nb_free, nb_R, nb_t = pad_triangulation_slots(
                    feats, nb_free, nb_R, nb_t, cfg.triangulation_neighbors)
            free1 = (store.kf_mp[kf1] < 0) & h1.valid

        with self.tracer.span("kernel"):
            enc, X = _triangulate(
                f1.desc, f1.uv_und, f1.level, self._dev(free1),
                [f.desc for f in feats], [f.uv_und for f in feats],
                [f.level for f in feats], self._dev(nb_free),
                self._dev(nb_R), self._dev(nb_t),
                self._dev(R1), self._dev(t1), self.K,
                self._dev(self.inv_sigma2),
                max_dist=cfg.match_th_low * 2, ratio=0.9, fmean=fmean,
                min_parallax_cos=cfg.triangulation_min_parallax_cos)
            enc, X = enc.cpu().numpy(), X.cpu().numpy()  # single host sync

        new_points = []
        desc1 = h1.desc
        for qi, kf2 in enumerate(keep):
            for i in np.nonzero(enc[qi] >= 0)[0]:
                j = int(enc[qi, i])
                if store.kf_mp[kf1, i] >= 0 or store.kf_mp[kf2, j] >= 0:
                    continue
                m = store.add_map_point(X[qi, i], desc1[i], kf1)
                store.add_observation(m, kf1, int(i))
                store.add_observation(m, kf2, j)
                new_points.append(m)
        store.update_normals_batch(np.array(new_points, np.int64),
                                   self.scale_factors)
        self.note_new_points(new_points, kf1)
        self.last_pass["new_points"] = len(new_points)

    # ------------------------------------------------------------------ #
    def _fuse_neighbors(self, kf: int):
        """Two-way projection fuse (SearchInNeighbors): all (src, dst) pairs
        evaluated in one call (mapping_kernels.fuse_pairs) and fetched once;
        the host applies merge/add verdicts sequentially."""
        cfg = self.cfg
        store = self.store
        neighbors = store.covisible_kfs(kf, min_weight=cfg.covis_weight_graph, max_n=10)
        pairs = [(kf, n) for n in neighbors] + [(n, kf) for n in neighbors]
        if pairs:
            self._fuse_pairs(pairs)
        # refresh descriptors of this KF's points after fusion
        self._process_new_keyframe(kf)

    def _fuse_pairs(self, pairs):
        cfg = self.cfg
        store = self.store
        Q = FUSE_PAIRS
        pairs = pairs[:Q]
        # a source KF observes at most n_feat points; the block's point axis
        # is BUCKETED (pow2) to the largest per-pair count — typical KFs
        # observe a few hundred points, and the desc upload is the dominant
        # KF-rate host->device cost
        P_cap = min(cfg.local_ba_max_points, cfg.n_features)
        per_pair = []
        for (src_kf, dst_kf) in pairs:
            mps = store.kf_mp[src_kf]
            mps = np.unique(mps[mps >= 0])
            per_pair.append(mps[store.mp_valid[mps]][:P_cap])
        P = 256
        while P < max((len(m) for m in per_pair), default=1) and P < P_cap:
            P *= 2
        P = min(P, P_cap)

        mp_blocks = np.zeros((Q, P), np.int64)
        mp_valid = np.zeros((Q, P), bool)
        dst_pose = np.zeros((Q, 7), np.float32)
        dst_pose[:, 0] = 1.0
        for qi, (src_kf, dst_kf) in enumerate(pairs):
            mps = per_pair[qi][:P]
            mp_blocks[qi, :len(mps)] = mps
            mp_valid[qi, :len(mps)] = True
            dst_pose[qi] = store.kf_pose[dst_kf]
        dst_feats = [store.kf_features[d] for _, d in pairs]
        n_live = len(pairs)
        if graphs.graph_path(dst_feats[0].desc):
            # a graph takes all Q pairs, as the reference (its padded pairs,
            # with the first pair's destination, match nothing): one graph
            # for each point bucket P
            dst_feats += [dst_feats[0]] * (Q - n_live)
            n_live = None

        with self.tracer.span("upload"):
            # descriptors ship bf16: the matcher's dot casts to bf16 anyway,
            # and the desc block is the dominant upload byte count
            blocks = (self._dev(store.mp_pos[mp_blocks]),
                      self._dev(store.mp_normal[mp_blocks]),
                      self._dev(store.mp_min_dist[mp_blocks]),
                      self._dev(store.mp_max_dist[mp_blocks]),
                      self._dev(store.mp_desc[mp_blocks], self._desc_dtype),
                      self._dev(mp_valid),
                      self._dev(dst_pose),
                      [f.desc for f in dst_feats],
                      [f.uv_und for f in dst_feats],
                      [f.level for f in dst_feats],
                      [f.valid for f in dst_feats])
        with self.tracer.span("kernel"):
            # elsewhere the padded pair slots (mp_valid all false) are filled
            # with -1 without a launch: only the live pairs are launched
            enc = _fuse(
                *blocks,
                self.K, self._dev(self.scale_factors),
                width=float(cfg.image_width), height=float(cfg.image_height),
                scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
                fuse_radius=cfg.fuse_radius, max_dist=cfg.match_th_high,
                n_live=n_live, use_kernel=cfg.use_pallas_match)
            enc = enc.cpu().numpy()  # single host sync
        self.last_pass["fuse_pairs"] = len(pairs)

        for qi, (src_kf, dst_kf) in enumerate(pairs):
            for a in np.nonzero(enc[qi] >= 0)[0]:
                m = int(mp_blocks[qi, a])
                if not store.mp_valid[m]:
                    continue  # merged away by an earlier pair
                feat = int(enc[qi, a])
                existing = int(store.kf_mp[dst_kf, feat])
                if existing >= 0 and existing != m and store.mp_valid[existing]:
                    # merge: keep the more-observed point
                    if store.mp_n_obs[existing] >= store.mp_n_obs[m]:
                        store.replace_map_point(m, existing)
                    else:
                        store.replace_map_point(existing, m)
                elif existing < 0:
                    store.add_observation(m, dst_kf, feat)

    # ------------------------------------------------------------------ #
    def _cull_keyframes(self, kf: int):
        """KeyFrameCulling (LocalMapping.cc:739-816): a covisible KF is
        redundant if >= 90% of its map points are seen by >= 3 other KFs at
        the same or finer scale.  Culled KFs keep their id (masked invalid);
        their observations are removed and the spanning tree reattached."""
        cfg = self.cfg
        store = self.store
        for cand in store.covisible_kfs(kf, min_weight=cfg.covis_weight_graph):
            cand = int(cand)
            if cand <= 1 or not store.kf_valid[cand]:
                continue  # never cull the two bootstrap KFs
            mps = store.kf_mp[cand]
            feats = np.nonzero(mps >= 0)[0]
            if len(feats) < 20:
                continue
            # vectorized redundancy count over this KF's points: an
            # observation is "fine" if another KF sees the point at the same
            # or finer (<= lvl+1) pyramid level
            m = mps[feats]
            live = store.mp_valid[m]
            obs_kf = store.mp_obs_kf[m]                      # [F, O]
            has = (obs_kf >= 0) & (obs_kf != cand) & live[:, None]
            safe_kf = np.where(obs_kf >= 0, obs_kf, 0)
            lvl_obs = store.kf_level_t[safe_kf, store.mp_obs_feat[m]]
            lvl = store.kf_level_t[cand, feats]
            fine = has & (lvl_obs <= lvl[:, None] + 1)
            n_redundant = int((fine.sum(1) >= 3).sum())
            if n_redundant >= cfg.kf_cull_redundancy * len(feats):
                self._erase_keyframe(cand)

    def _erase_keyframe(self, kf: int):
        store = self.store
        mps = store.kf_mp[kf]
        for f in np.nonzero(mps >= 0)[0]:
            store.erase_observation(int(mps[f]), kf)
        store.kf_valid[kf] = False
        # capture the cull-time relative pose to the spanning-tree parent
        # (the reference's mTcp, KeyFrame::SetBadFlag) so frame-trajectory
        # recomposition can bridge culled reference KFs (System.cc:523-528)
        parent = store.kf_parent[kf]
        if parent >= 0:
            Rk, tk = _pose_np(store.kf_pose[kf])
            Rp, tp = _pose_np(store.kf_pose[parent])
            Rr = Rk @ Rp.T
            tr = tk - Rr @ tp
            store.kf_cull_parent[kf] = parent
            store.kf_cull_rel[kf] = np.concatenate(
                [_mat_to_quat_np_batch(Rr[None])[0], tr]).astype(np.float32)
        for child in np.nonzero(store.kf_parent[:store.n_kf] == kf)[0]:
            store.kf_parent[child] = parent
        if self.loop_closer is not None and self.loop_closer.db is not None:
            self.loop_closer.db.erase(kf)

    # ------------------------------------------------------------------ #
    def _local_ba(self, kf: int):
        cfg = self.cfg
        store = self.store
        from asdslam_torch.frontend.tracking import _assemble_ba, _write_back

        window = [kf] + store.covisible_kfs(kf, min_weight=cfg.covis_weight_graph,
                                            max_n=cfg.local_ba_max_kfs - 1)
        window_set = set(window)
        # fixed anchors: KFs observing window points but outside the window
        mp_ids = store.local_map_points(window)
        fixed = []
        for m in mp_ids:
            n = store.mp_n_obs[m]
            for kf2 in store.mp_obs_kf[m, :n]:
                if kf2 not in window_set and kf2 not in fixed:
                    fixed.append(int(kf2))
        fixed = fixed[:cfg.local_ba_max_fixed]
        # gauge: monocular BA needs enough FIXED cameras or the scale gauge
        # drifts (one fixed camera pins translation/rotation but leaves the
        # scale gauge free — observed as runaway map shrinkage).  The
        # reference gets anchors implicitly: its window is the covisible set
        # and every OTHER observer is fixed (Optimizer.cc:462-476).  With a
        # wide window in a dense-covisibility revisit region, the window can
        # swallow nearly every observer, leaving 1-2 weak anchors — the
        # r4 full-scale seq-00 run showed exactly that failure as recurring
        # window-local scale collapse (drift_kf windows with local scale
        # 0.19/310).  Guarantee anchors >= max(2, |window|/4) by demoting
        # the weakest-covisibility window KFs to fixed.
        if 0 in window and 0 not in fixed:
            window.remove(0)
            fixed.append(0)
        min_anchors = max(2, len(window) // 4)
        while len(fixed) < min_anchors and len(window) > 1:
            fixed.append(window.pop())
        if len(fixed) < 2 or not window:
            return
        with self.tracer.span("assemble"):
            asm = _assemble_ba(store, window, fixed, cfg, self.inv_sigma2,
                               bucket_cams=True, device=self.device)
        if asm is None:
            return
        with self.tracer.span("solve"):
            poses, points, chi2 = ba.bundle_adjust(
                asm.problem, self.K, n_opt=asm.n_opt,
                iters=cfg.local_ba_iters1 + cfg.local_ba_iters2)
            out_mask = chi2 > cfg.chi2_mono
            poses, points, out_np = (poses.cpu().numpy(), points.cpu().numpy(),
                                     out_mask.cpu().numpy())
        self.last_pass["local_ba"] = {
            "n_opt": asm.n_opt, "points": int(asm.problem.points.shape[0]),
            "obs": int(asm.problem.obs.uv.shape[0]),
            "k_max": int(asm.problem.pt_obs.shape[1]),
            "finite": bool(np.isfinite(poses).all() and np.isfinite(points).all())}
        with self.tracer.span("write_back"):
            _write_back(store, asm, poses, points, outliers=out_np)
