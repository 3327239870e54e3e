"""Loop closing: detection, Sim3 verification, loop correction, essential
graph optimization, global BA.

Port of ``asdslam_tpu/loop/loop_closing.py``, the mirror of
src/vslam/src/LoopClosing.cc (DoLoopDetect: DetectLoop -> ComputeSim3 ->
CorrectLoop), run after each keyframe's mapping pass:

- DetectLoop (133-267): min-score gate from covisible BoW scores, database
  candidates, 3-consecutive consistency groups (mnCovisibilityConsistencyTh=3)
- ComputeSim3 (269-441): feature matching between mapped features, batched
  RANSAC Horn Sim3 (Sim3Solver parity), GN refinement (OptimizeSim3 parity),
  guided-projection support check (>= 40 total matches)
- CorrectLoop (443-601): propagate corrected Sim3 through the covisible
  group, remap its map points, fuse against the loop side, optimize the
  essential graph (spanning tree + loop + strong covisibility edges), then
  run global BA (RunGlobalBundleAdjustment, 660-765).

The vocabulary is trained online from the first keyframes' descriptors when
none is supplied.

Random draws (the vocabulary's fallback picks and each candidate's Sim3
RANSAC samples) come from ``LoopCloser._vocab_draws`` / ``_sim3_draws``:
CPU ``torch.Generator``s seeded as the reference seeds its keys (11, and the
keyframe id), so a CPU run and a CUDA run see the same draws; a test may
replace the methods to replay the JAX streams.  The funnel's device work is
four module-level programs, each ``graphs.captured`` (the reference jits
each) and so replayed from a CUDA graph on the card: the global search, the
Sim3 RANSAC with its refine, the two guided searches of the mutual check,
and a projection search (the correction's fuse).  The projection searches go through
``match.search_projection``, so on a CUDA device through the masked-NN
kernel.  ``cfg.n_devices > 1`` routes the global BA through the
point-major mesh solver (``parallel/dist.py``), as the reference does; the
port's mesh puts its shards on the cards there are, sharing them where
there are fewer cards than shards, so it never falls back to the one-device
global BA (the reference does where it has fewer chips).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from asdslam_torch.backend import ba, global_ba, pose_graph
from asdslam_torch.config import SlamConfig
from asdslam_torch.estimators import sim3_horn
from asdslam_torch.frontend import visibility
from asdslam_torch.geometry import se3
from asdslam_torch.loop import vocab as vocab_mod
from asdslam_torch.loop.keyframe_db import KeyFrameDatabase
from asdslam_torch.ops import match
from asdslam_torch.parallel import dist
from asdslam_torch.mapping.map_store import (
    MapStore, _mat_to_quat_np_batch, _pose_np, _pose_np_batch)
from asdslam_torch.utils import graphs
from asdslam_torch.utils.tracing import Tracer


def _quat(R: np.ndarray) -> np.ndarray:
    """se3.matrix_to_quat of one rotation, on the host."""
    return se3.matrix_to_quat(torch.from_numpy(np.asarray(R, np.float32))).numpy()


def _pow2(n: int, lo: int = 4096) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------- #
# The loop funnel's device programs, each captured (the reference jits each)
# --------------------------------------------------------------------------- #
def sim3_program(g, P1, P2, uv1, uv2, valid, K, chi2_px1, chi2_px2, inv_s2_1, inv_s2_2,
                 min_inliers: int):
    """``sim3_horn.ransac_sim3`` then ``refine_sim3`` from its hypothesis and
    inliers (the reference jits each, sim3_horn.py:64 and :139; nothing is
    read between them).  Returns (success, s, R, t, refined inliers)."""
    res = sim3_horn.ransac_sim3(g, P1, P2, uv1, uv2, valid, K, chi2_px1, chi2_px2,
                                min_inliers=min_inliers)
    s, R, t, inl = sim3_horn.refine_sim3(res.s, res.R, res.t, P1, P2, uv1, uv2, res.inliers,
                                         K, inv_s2_1, inv_s2_2)
    return res.success, s, R, t, inl


def project_search(pose7, K, pos, normal, min_dist, max_dist_mp, valid_a, desc_a,
                   desc_b, uv_b, valid_b, scale_dev, radius: float, bounds, max_dist: float,
                   scale_factor: float, n_levels: int, use_kernel: bool):
    """SearchByProjection of a padded block of map points through ``pose7``
    into a keyframe's features: ``visibility.project_points`` (any viewing
    angle) and ``match.search_projection`` with radius x the predicted
    level's scale.  Returns (idx, ok)."""
    bx0, bx1, by0, by1 = bounds
    uv, pred_level, _, vis = visibility.project_points(
        pose7, K, pos, normal, min_dist, max_dist_mp, valid_a, bx1, by1,
        scale_factor, n_levels, min_view_cos=-1.0, x_min=bx0, y_min=by0)
    radii = radius * scale_dev[pred_level.to(torch.int64)]
    idx, _, ok = match.search_projection(desc_a, desc_b, uv, uv_b, vis, valid_b, radii,
                                         max_dist, ratio=1.0, use_kernel=use_kernel)
    return idx, ok


def guided_counts(fwd, bwd, **constants):
    """The matches of ``project_search`` on two blocks, as int32 [2]."""
    return torch.stack([torch.sum(project_search(*block, **constants)[1], dtype=torch.int32)
                        for block in (fwd, bwd)])


_search_global = graphs.captured(match.search_global, "loop_search_global")
_sim3 = graphs.captured(sim3_program, "loop_sim3")
_guided_counts = graphs.captured(guided_counts, "loop_guided")
_project_search = graphs.captured(project_search, "loop_project_search")


class LoopCloser:
    def __init__(self, cfg: SlamConfig, K, store: MapStore,
                 vocabulary: Optional[vocab_mod.Vocabulary] = None,
                 vocab_min_kfs: int = 5, run_global_ba: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.store = store
        self.vocab = vocabulary
        self.vocab_min_kfs = vocab_min_kfs
        self.run_global_ba = run_global_ba
        self.db: Optional[KeyFrameDatabase] = None
        self.kf_bow: Dict[int, np.ndarray] = {}
        self.pending: List[int] = []
        self.prev_groups: List[tuple] = []   # (set_of_kfs, consecutive_count)
        self.last_loop_kf = -10**9
        self.n_loops_closed = 0
        # localization mode: restrict loop candidates to prior-map KFs
        # (only_global_map, KeyFrameDatabase.cc:146)
        self.only_global_map = False
        self.inv_sigma2 = np.asarray(cfg.inv_level_sigma2, np.float32)
        self.scale_factors = np.asarray(cfg.scale_factors, np.float32)
        self._scale_dev = torch.as_tensor(self.scale_factors).to(self.device)
        self._desc_dtype = torch.bfloat16 if cfg.desc_upload_bf16 else torch.float32
        # detection-funnel counters: how many opportunities survive each gate
        # (diagnosis artifact for loop recall — not in the reference)
        self.counters = {"detect_calls": 0, "db_candidates": 0,
                         "consistent": 0, "match_gate": 0, "ransac_pass": 0,
                         "refine_pass": 0, "guided_pass": 0, "accepted": 0}
        self.accepted_log: List[tuple] = []   # (kf, cand, frame_id of kf)
        self.tracer = Tracer(enabled=False)  # System installs a live one

    def _dev(self, x, dtype=None):
        t = torch.as_tensor(np.ascontiguousarray(x)).to(self.device)
        return t if dtype is None else t.to(dtype)

    def _vocab_draws(self, n: int):
        """The vocabulary's fallback picks (``vocab.draw_rand_idx``), from a
        generator seeded 11 (the reference's PRNGKey(11))."""
        gen = torch.Generator(device="cpu").manual_seed(11)
        return vocab_mod.draw_rand_idx(gen, n, self.cfg.vocab_branching, self.cfg.vocab_depth)

    def _sim3_draws(self, kf: int, iters: int, n: int):
        """[iters, n] uniform draws for one candidate's Sim3 RANSAC, from a
        generator seeded with the keyframe id (the reference's PRNGKey(kf))."""
        gen = torch.Generator(device="cpu").manual_seed(int(kf))
        return torch.rand((iters, n), generator=gen, dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------ #
    def process(self, kf: int):
        cfg = self.cfg
        if self.vocab is None:
            self.pending.append(kf)
            if len(self.pending) >= self.vocab_min_kfs:
                self._train_vocab()
            return
        with self.tracer.span("bow"):
            self._add_kf_bow(kf)
        if kf < self.last_loop_kf + cfg.loop_min_kfs_between or self.store.n_kf < 6:
            self.db.add(kf, self.kf_bow[kf])
            return
        self.counters["detect_calls"] += 1
        with self.tracer.span("detect"):
            cands = self._detect_loop(kf)
        self.db.add(kf, self.kf_bow[kf])
        for cand in cands:
            with self.tracer.span("sim3"):
                ok = self._compute_sim3_and_correct(kf, cand)
            if ok:
                self.counters["accepted"] += 1
                self.accepted_log.append(
                    (int(kf), int(cand), int(self.store.kf_frame_id[kf])))
                self.last_loop_kf = kf
                self.n_loops_closed += 1
                self.prev_groups = []
                break

    # ------------------------------------------------------------------ #
    def _train_vocab(self):
        descs = []
        for kf in self.pending:
            h = self.store.kf_host[kf]
            descs.append(h.desc[h.valid])
        D = np.concatenate(descs, axis=0)
        if len(D) < 1000:
            return
        # fixed training-set shape: the online fallback trains on far less
        # data than an offline vocabulary (train_vocab.py / --voc_addr, the
        # reference's small_voc.yml.gz path) — say so instead of silently
        # degrading loop recall
        CAP = 16384
        print(f"[loop_closing] training ONLINE vocabulary from {len(D)} "
              f"descriptors (capped {CAP}); for best loop recall supply an "
              f"offline vocabulary via --voc_addr (train_vocab.py)",
              flush=True)
        if len(D) >= CAP:
            sel = np.random.default_rng(11).choice(len(D), CAP, replace=False)
            D = D[sel]
        else:
            reps = -(-CAP // len(D))
            D = np.tile(D, (reps, 1))[:CAP]
        with self.tracer.span("vocab_train"):
            self.vocab = vocab_mod.train_vocab(
                self._dev(D), self._vocab_draws(len(D)),
                branching=self.cfg.vocab_branching, depth=self.cfg.vocab_depth)
        self.db = KeyFrameDatabase(self.cfg, self.vocab.n_words, self.store.max_kfs)
        with self.tracer.span("vocab_index"):
            for kf in self.pending:
                self._add_kf_bow(kf)
                self.db.add(kf, self.kf_bow[kf])
        self.pending = []

    def _add_kf_bow(self, kf: int):
        if self.db is None:
            self.db = KeyFrameDatabase(self.cfg, self.vocab.n_words, self.store.max_kfs)
        f = self.store.kf_features[kf]
        words = vocab_mod.transform(self.vocab, f.desc, f.valid)
        self.kf_bow[kf] = vocab_mod.bow_vector(self.vocab, words)

    # ------------------------------------------------------------------ #
    def _detect_loop(self, kf: int) -> List[int]:
        """Returns ALL consistency-passing candidates, best group first —
        ComputeSim3 tries each (mvpEnoughConsistentCandidates semantics)."""
        cfg = self.cfg
        store = self.store
        covis = store.covisible_kfs(kf, min_weight=cfg.covis_weight_graph)
        if not covis:
            return []
        my_bow = self.kf_bow[kf]
        min_score = min(
            (vocab_mod.score_l1(my_bow, self.kf_bow[c]) for c in covis if c in self.kf_bow),
            default=0.0)
        recent = set(range(max(0, kf - cfg.loop_exclude_recent_kfs), kf + 1))
        restrict = None
        if self.only_global_map and store.kf_global[:store.n_kf].any():
            restrict = store.kf_global
        candidates = self.db.detect_loop_candidates(
            kf, my_bow, set(covis) | recent, min_score,
            lambda k: store.covisible_kfs(k, min_weight=cfg.covis_weight_graph, max_n=10),
            restrict_mask=restrict)
        if not candidates:
            self.prev_groups = []
            return []
        self.counters["db_candidates"] += len(candidates)

        # consistency groups (LoopClosing.cc:196-249)
        new_groups = []
        accepted = []
        for c in candidates:
            group = set(store.covisible_kfs(c, min_weight=cfg.covis_weight_graph, max_n=10)) | {c}
            count = 0
            for (pg, pc) in self.prev_groups:
                if group & pg:
                    count = max(count, pc + 1)
            new_groups.append((group, count))
            if count + 1 >= cfg.loop_consistency_th:
                accepted.append(c)
        self.prev_groups = new_groups
        self.counters["consistent"] += len(accepted)
        return accepted

    # ------------------------------------------------------------------ #
    def _compute_sim3_and_correct(self, kf: int, cand: int) -> bool:
        cfg = self.cfg
        store = self.store
        f1 = store.kf_features[kf]
        f2 = store.kf_features[cand]
        mp1 = store.kf_mp[kf]
        mp2 = store.kf_mp[cand]
        v1 = self._dev(mp1 >= 0) & f1.valid
        v2 = self._dev(mp2 >= 0) & f2.valid
        idx, d, mok = _search_global(
            f1.desc, f2.desc, v1, v2,
            max_dist=cfg.match_th_low * 2, ratio=cfg.match_nn_ratio_loop)
        idx_np, mok_np = idx.cpu().numpy(), mok.cpu().numpy()
        if mok_np.sum() < cfg.sim3_ransac_min_inliers:
            return False
        self.counters["match_gate"] += 1

        # matched map point 3D in each camera frame (fixed-shape arrays)
        R1, t1 = _pose_np(store.kf_pose[kf])
        R2, t2 = _pose_np(store.kf_pose[cand])
        m1 = np.where(mok_np, mp1, 0)
        m2 = np.where(mok_np, mp2[idx_np], 0)
        valid = mok_np & store.mp_valid[m1] & store.mp_valid[m2]
        P1 = store.mp_pos[m1] @ R1.T + t1
        P2 = store.mp_pos[m2] @ R2.T + t2
        h1, h2 = store.kf_host[kf], store.kf_host[cand]
        uv1 = h1.uv_und
        uv2 = h2.uv_und[idx_np]
        lvl1 = h1.level
        lvl2 = h2.level[idx_np]
        th1 = 9.21 / self.inv_sigma2[lvl1]
        th2 = 9.21 / self.inv_sigma2[lvl2]

        # the RANSAC and the refine as one program, fetched once: the refine
        # runs whatever the RANSAC's verdict, its result simply unused when
        # success is False
        out = _sim3(
            self._sim3_draws(kf, cfg.sim3_ransac_iters, len(P1)),
            *(self._dev(x) for x in (P1, P2, uv1, uv2, valid)), self.K,
            *(self._dev(x) for x in (th1, th2, self.inv_sigma2[lvl1], self.inv_sigma2[lvl2])),
            min_inliers=cfg.sim3_ransac_min_inliers)
        success, s, R, t, inl = (x.cpu().numpy() for x in out)
        if not bool(success):
            return False
        self.counters["ransac_pass"] += 1
        n_inl = int(inl.sum())
        if n_inl < cfg.sim3_min_inliers:
            return False
        self.counters["refine_pass"] += 1

        # bidirectional guided support check (ORBmatcher::SearchBySim3 via
        # LoopClosing::ComputeSim3, LoopClosing.cc:269-441): project the loop
        # side's points into kf through S^{-1} AND kf's own local points into
        # cand through S; both directions must support the loop — one-way
        # agreement is weak evidence when descriptors alias.
        S_ck = (float(s), np.asarray(R), np.asarray(t))   # kf-cam -> cand-cam

        loop_kfs = [cand] + store.covisible_kfs(cand, min_weight=cfg.covis_weight_graph, max_n=10)
        loop_mps = store.local_map_points(loop_kfs)
        own_kfs = [kf] + store.covisible_kfs(kf, min_weight=cfg.covis_weight_graph, max_n=10)
        own_mps = store.local_map_points(own_kfs)

        # world -> kf-cam corrected chain: x_kf = S^{-1}(R2 X + t2); with
        # the 1/s depth scale folded into translation (projection is
        # invariant to a global scaling of camera coords):
        Rn, tn = S_ck[1], S_ck[2]
        pose_fwd = np.concatenate([
            _quat(Rn.T @ R2), ((Rn.T @ (t2 - tn)) / S_ck[0]).astype(np.float32)])
        # world -> cand-cam corrected chain: x_cand = S(Rk X + tk) = s R Rk X
        # + s R tk + t; scale-folded: (R Rk, R tk + t/s)
        Rk, tk = _pose_np(store.kf_pose[kf])
        pose_bwd = np.concatenate([
            _quat(Rn @ Rk), (Rn @ tk + tn / S_ck[0]).astype(np.float32)])

        n_fwd, n_bwd = (int(x) for x in self._guided_support(
            kf, pose_fwd, loop_mps, cand, pose_bwd, own_mps).cpu())
        total = max(n_inl, min(n_fwd, n_bwd))
        if total < cfg.loop_min_total_matches:
            return False
        self.counters["guided_pass"] += 1

        self._correct_loop(kf, cand, S_ck, loop_mps)
        return True

    def _search_block(self, pose7, mps, dst_kf: int):
        """The device arguments of a projection search (SearchByProjection)
        of the map points ``mps``, padded to ``local_ba_max_points`` rows,
        through ``pose7`` into ``dst_kf``'s features (``project_search``'s
        first twelve), and the padded point ids."""
        store = self.store
        P = self.cfg.local_ba_max_points
        mps = np.asarray(mps, np.int64)[:P]
        pad = P - len(mps)
        mp_p = np.pad(mps, (0, pad), constant_values=0)
        valid_a = np.pad(np.ones(len(mps), bool), (0, pad))
        fd = store.kf_features[dst_kf]
        block = (self._dev(pose7, torch.float32), self.K,
                 self._dev(store.mp_pos[mp_p]), self._dev(store.mp_normal[mp_p]),
                 self._dev(store.mp_min_dist[mp_p]), self._dev(store.mp_max_dist[mp_p]),
                 self._dev(valid_a), self._dev(store.mp_desc[mp_p], self._desc_dtype),
                 fd.desc, fd.uv_und, fd.valid, self._scale_dev)
        return mp_p, block

    def _search_constants(self, radius: float):
        cfg = self.cfg
        return dict(radius=radius, bounds=tuple(cfg.undistorted_bounds),
                    max_dist=cfg.match_th_high, scale_factor=cfg.scale_factor,
                    n_levels=cfg.n_levels, use_kernel=cfg.use_pallas_match)

    def _guided_support(self, kf: int, pose_fwd, loop_mps, cand: int, pose_bwd, own_mps):
        """The SearchBySim3 mutual check's two SearchByProjections, one
        program: the loop side's points into kf through the Sim3-corrected
        (scale-folded) ``pose_fwd``, kf's own points into cand through
        ``pose_bwd``.  Returns the two match counts as a DEVICE int32 [2]
        (the caller fetches them at once); an empty side counts 0."""
        _, fwd = self._search_block(pose_fwd, loop_mps, kf)
        _, bwd = self._search_block(pose_bwd, own_mps, cand)
        return _guided_counts(fwd, bwd, **self._search_constants(10.0))

    def _count_guided_matches(self, dst_kf: int, pose_corr, mps):
        """One direction of the mutual check (the reference's call): the
        matches of map points ``mps`` in dst_kf's features through
        ``pose_corr``, a DEVICE int32 scalar."""
        _, block = self._search_block(pose_corr, mps, dst_kf)
        return torch.sum(_project_search(*block, **self._search_constants(10.0))[1],
                         dtype=torch.int32)

    # ------------------------------------------------------------------ #
    def _correct_loop(self, kf: int, cand: int, S_ck, loop_mps):
        cfg = self.cfg
        store = self.store
        s, R, t = S_ck

        # corrected sim3 pose of kf: S maps kf-cam -> cand-cam, the cand side
        # is trusted, so S_kf_w_corr = S^{-1} o T_cand_w (analog of ORB-SLAM2's
        # mScw = gScm * matchedKF pose, LoopClosing.cc CorrectLoop).
        si, Ri, ti = 1.0 / s, R.T, -(R.T @ t) / s
        R2, t2 = _pose_np(store.kf_pose[cand])
        # compose sim3 (si, Ri, ti) o se3 (R2, t2):
        s_corr = si
        R_corr = Ri @ R2
        t_corr = si * (Ri @ t2) + ti

        # old pose of kf
        Rk, tk = _pose_np(store.kf_pose[kf])

        group = [kf] + store.covisible_kfs(kf, min_weight=cfg.covis_weight_graph)
        corrected: Dict[int, tuple] = {}
        non_corrected: Dict[int, tuple] = {}
        for g in group:
            Rg, tg = _pose_np(store.kf_pose[g])
            non_corrected[g] = (1.0, Rg, tg)
            # relative: T_g_kf = T_g_w o T_kf_w^-1
            Rrel = Rg @ Rk.T
            trel = tg - Rrel @ tk
            # corrected: S_g_w = T_g_kf o S_kf_w_corr
            sg = s_corr
            Rg_c = Rrel @ R_corr
            tg_c = Rrel @ t_corr + trel * 1.0  # trel scales by rel scale (=1)
            corrected[g] = (sg, Rg_c, tg_c)

        # correct map points of the group — batched: each point is remapped
        # through the FIRST group KF observing it (the reference's
        # mnCorrectedByKF guard)
        Rg_all = np.stack([non_corrected[g][1] for g in group])
        tg_all = np.stack([non_corrected[g][2] for g in group])
        sg_all = np.asarray([corrected[g][0] for g in group], np.float32)
        Rgc_all = np.stack([corrected[g][1] for g in group])
        tgc_all = np.stack([corrected[g][2] for g in group])
        mp_lists = [np.unique(store.kf_mp[g][store.kf_mp[g] >= 0]) for g in group]
        all_m = (np.concatenate(mp_lists) if mp_lists
                 else np.zeros(0, np.int64)).astype(np.int64)
        owner = np.concatenate(
            [np.full(len(l), gi, np.int64) for gi, l in enumerate(mp_lists)]
        ) if mp_lists else np.zeros(0, np.int64)
        _, first_idx = np.unique(all_m, return_index=True)  # first occurrence
        m_sel, own = all_m[first_idx], owner[first_idx]
        live = store.mp_valid[m_sel] if len(m_sel) else np.zeros(0, bool)
        m_sel, own = m_sel[live], own[live]
        if len(m_sel):
            X = store.mp_pos[m_sel]
            xc = np.einsum("mij,mj->mi", Rg_all[own], X) + tg_all[own]
            # X' = S_g_corr^{-1}(xc)
            store.mp_pos[m_sel] = np.einsum(
                "mji,mj->mi", Rgc_all[own], xc - tgc_all[own]) / sg_all[own][:, None]
        done = set(int(m) for m in m_sel)
        for gi, g in enumerate(group):
            # update pose (fold scale into translation)
            pose = np.concatenate([
                _quat(Rgc_all[gi]), (tgc_all[gi] / sg_all[gi]).astype(np.float32)])
            store.set_kf_pose(g, pose)

        # fuse loop map points into the corrected group
        with self.tracer.span("fuse"):
            for g in group:
                self._fuse_mps_into_kf(loop_mps, g)

        # essential graph optimization
        with self.tracer.span("essential_graph"):
            self._optimize_essential_graph(kf, cand, corrected, non_corrected)
        store.loop_edges.append((kf, cand))

        # global BA
        if self.run_global_ba:
            with self.tracer.span("gba"):
                self._global_ba()

        # refresh normals/descriptors
        store.update_normals_batch(
            np.fromiter(done, np.int64, len(done)), self.scale_factors)

    def _fuse_mps_into_kf(self, mps, dst_kf: int):
        cfg = self.cfg
        store = self.store
        mps = np.asarray([m for m in mps if store.mp_valid[m]], np.int32)
        if len(mps) == 0:
            return
        mp_p, block = self._search_block(store.kf_pose[dst_kf], mps, dst_kf)
        idx, ok = _project_search(*block, **self._search_constants(cfg.fuse_radius))
        idx_np, ok_np = idx.cpu().numpy(), ok.cpu().numpy()
        for a in np.nonzero(ok_np)[0]:
            m = int(mp_p[a])
            feat = int(idx_np[a])
            existing = int(store.kf_mp[dst_kf, feat])
            if existing >= 0 and existing != m and store.mp_valid[existing]:
                # loop point wins (reference: SearchAndFuse replaces)
                store.replace_map_point(existing, m)
            elif existing < 0:
                store.add_observation(m, dst_kf, feat)

    # ------------------------------------------------------------------ #
    def _optimize_essential_graph(self, kf, cand, corrected, non_corrected):
        """Host assembly is vectorized numpy over the SoA store; the
        optimizer is one device call fetched once."""
        cfg = self.cfg
        store = self.store
        K = store.n_kf
        # stored poses are already (quat, t): poses8 = [q, t, log_s=0]
        poses8 = np.concatenate([store.kf_pose[:K],
                                 np.zeros((K, 1), np.float32)], axis=1)

        # ---- edge lists (spanning tree > loop > strong covisibility; first
        # occurrence wins the dedup, preserving the reference's precedence)
        ea, eb, ew = [], [], []
        ks = np.arange(K)
        parents = store.kf_parent[:K]
        st = parents >= 0
        ea.append(parents[st].astype(np.int64))
        eb.append(ks[st].astype(np.int64))
        ew.append(np.ones(int(st.sum()), np.float32))
        loop_pairs = list(store.loop_edges) + [(kf, cand)]
        ea.append(np.asarray([a for a, _ in loop_pairs], np.int64))
        eb.append(np.asarray([b for _, b in loop_pairs], np.int64))
        ew.append(np.full(len(loop_pairs), 5.0, np.float32))
        cov_a, cov_b = [], []
        for k in range(K):
            for nb in store.covisible_kfs(k, min_weight=cfg.covis_weight_essential):
                cov_a.append(k)
                cov_b.append(int(nb))
        ea.append(np.asarray(cov_a, np.int64))
        eb.append(np.asarray(cov_b, np.int64))
        ew.append(np.ones(len(cov_a), np.float32))
        a = np.concatenate(ea)
        b = np.concatenate(eb)
        w = np.concatenate(ew)
        ok = a != b
        a, b, w = a[ok], b[ok], w[ok]
        if len(a) == 0:
            return
        key = np.minimum(a, b) * np.int64(store.max_kfs + 1) + np.maximum(a, b)
        _, first = np.unique(key, return_index=True)
        first.sort()
        a, b, w = a[first], b[first], w[first]

        # ---- batched relative Sim3 measurements S_ba = T_b o T_a^-1
        Ra, ta = _pose_np_batch(store.kf_pose[a])
        Rb, tb = _pose_np_batch(store.kf_pose[b])
        Rr = np.einsum("eij,ekj->eik", Rb, Ra)          # Rb @ Ra^T
        tr = tb - np.einsum("eij,ej->ei", Rr, ta)
        metas = np.concatenate([_mat_to_quat_np_batch(Rr), tr,
                                np.zeros((len(a), 1), np.float32)],
                               axis=1).astype(np.float32)

        edges = pose_graph.PoseGraphEdges(
            i=self._dev(a), j=self._dev(b), meas=self._dev(metas),
            weight=self._dev(w), valid=torch.ones(len(a), dtype=torch.bool, device=self.device))
        fixed = np.zeros(K, bool)
        fixed[cand] = True
        opt = pose_graph.optimize_pose_graph(
            self._dev(poses8), edges, self._dev(fixed), iters=15).cpu().numpy()

        # ---- write back (fold scale into SE3) + batched point correction
        pre_R, pre_t = _pose_np_batch(store.kf_pose[:K])
        sk = np.exp(opt[:, 7]).astype(np.float32)
        q = opt[:, :4].astype(np.float32)
        t_new = (opt[:, 4:7] / sk[:, None]).astype(np.float32)
        store.kf_pose[:K, :4] = q / np.linalg.norm(q, axis=1, keepdims=True)
        store.kf_pose[:K, 4:7] = t_new
        R_new, _ = _pose_np_batch(store.kf_pose[:K])
        store.kf_center[:K] = -np.einsum("kji,kj->ki", R_new, t_new)

        live = store.mp_valid[:store.n_mp] & (store.mp_n_obs[:store.n_mp] > 0)
        mids = np.nonzero(live)[0]
        if len(mids):
            ref = store.mp_obs_kf[mids, 0]
            pos = store.mp_pos[mids]
            xc = np.einsum("mij,mj->mi", pre_R[ref], pos) + pre_t[ref]
            xc = xc / sk[ref][:, None] - t_new[ref]
            store.mp_pos[mids] = np.einsum("mji,mj->mi", R_new[ref], xc)

    # ------------------------------------------------------------------ #
    def _global_ba(self):
        cfg = self.cfg
        store = self.store
        K_kfs = store.n_kf
        mp_ids = np.nonzero(store.mp_valid[:store.n_mp])[0]
        if len(mp_ids) == 0 or K_kfs < 3:
            return
        pt_row, kfs, feats = store.observation_rows(mp_ids)
        # observation axis BUCKETED (pow2) to the actual row count; the 4M
        # guard is a memory backstop far above any real sequence
        max_obs_guard = 1 << 22
        if len(pt_row) > max_obs_guard:
            print(f"[loop_closing] global BA dropping "
                  f"{len(pt_row) - max_obs_guard} of {len(pt_row)} observation "
                  f"rows (memory guard {max_obs_guard})", flush=True)
            pt_row, kfs, feats = (pt_row[:max_obs_guard], kfs[:max_obs_guard],
                                  feats[:max_obs_guard])
        O = len(pt_row)
        O_pad = _pow2(O)
        cam_idx = np.zeros(O_pad, np.int64)
        pt_idx = np.zeros(O_pad, np.int64)
        uv = np.zeros((O_pad, 2), np.float32)
        inv_s2 = np.ones(O_pad, np.float32)
        valid = np.zeros(O_pad, bool)
        cam_idx[:O] = kfs
        pt_idx[:O] = pt_row
        uv[:O] = store.kf_uv_t[kfs, feats]
        inv_s2[:O] = self.inv_sigma2[store.kf_level_t[kfs, feats]]
        valid[:O] = True

        # gauge: optimize all but the FIRST keyframe (moved to the end slot)
        order = list(range(1, K_kfs)) + [0]
        inv_order = np.argsort(order)
        poses = store.kf_pose[np.asarray(order)]
        cam_idx = np.asarray(inv_order, np.int64)[cam_idx]

        P = len(mp_ids)
        if cfg.n_devices > 1:
            # the same assembled problem through the point-major mesh solver
            with self.tracer.span("gba_mesh"):
                poses_o, points_o = self._global_ba_mesh(
                    poses, mp_ids, cam_idx, pt_idx, uv, inv_s2, valid, n_opt=K_kfs - 1)
            for i, k in enumerate(order):
                store.set_kf_pose(k, poses_o[i])
            store.mp_pos[mp_ids] = points_o
            return
        obs = ba.Obs(cam_idx=self._dev(cam_idx), pt_idx=self._dev(pt_idx),
                     uv=self._dev(uv), inv_sigma2=self._dev(inv_s2),
                     valid=self._dev(valid))
        # gather tables: the per-point and per-camera sums read them
        kp = _pow2(int(np.bincount(pt_idx[valid], minlength=1).max()), lo=4)
        kc = _pow2(int(np.bincount(cam_idx[valid], minlength=1).max()), lo=4)
        pt_tab = self._dev(ba.build_pt_obs(pt_idx, valid, P, kp))
        cam_tab = self._dev(ba.build_pt_obs(cam_idx, valid, K_kfs - 1, kc))
        poses_o, points_o, chi2 = global_ba.global_bundle_adjust(
            self._dev(poses), self._dev(store.mp_pos[mp_ids]),
            torch.ones(P, dtype=torch.bool, device=self.device), obs, self.K,
            n_opt=K_kfs - 1, iters=cfg.loop_gba_iters, cg_iters=40,
            pt_obs=pt_tab, cam_obs=cam_tab)
        poses_o, points_o = poses_o.cpu().numpy(), points_o.cpu().numpy()
        for i, k in enumerate(order):
            store.set_kf_pose(k, poses_o[i])
        store.mp_pos[mp_ids] = points_o

    def _global_ba_mesh(self, poses, mp_ids, cam_idx, pt_idx, uv, inv_s2, valid,
                        n_opt: int):
        """Loop-closure GBA over a mesh of ``cfg.n_devices`` shards on this
        closer's device type: the point-major layout and its gather tables
        once, then ``loop_gba_iters`` damped Gauss-Newton steps of the
        distributed Schur solver, on the calling thread's current stream.
        Each step is two captured programs a device (``dist.pm_local_blocks``
        and ``dist.pm_update``) around the eager ``Mesh.psum``; the loop's
        steps share one key a device, so on the card the first step warms
        the programs, the second captures them and the rest replay.  The
        step runs in float64, so the result does not depend on the mesh
        size (``parallel/dist.py``)."""
        cfg = self.cfg
        mesh = dist.make_mesh(cfg.n_devices, device=self.device)
        (points_pm, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad) = dist.layout_point_major(
            self.store.mp_pos[mp_ids], cam_idx, pt_idx, uv, inv_s2, valid, mesh.size)
        obs_pm = dist.shard_observations(mesh, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad, n_opt)
        points_d = dist.shard_to_mesh(mesh, points_pm, "data")
        poses_d = self._dev(np.asarray(poses, np.float32))
        step = dist.make_pm_step(mesh, n_opt, lam=1e-3)
        for _ in range(cfg.loop_gba_iters):
            poses_d, points_d = step(poses_d, points_d, obs_pm, self.K)
        return poses_d.cpu().numpy(), mesh.gather(points_d).cpu().numpy()[:len(mp_ids)]
