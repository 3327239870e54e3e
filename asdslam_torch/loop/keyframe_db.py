"""Keyframe BoW database: loop / relocalization candidate retrieval.

Copy of ``asdslam_tpu/loop/keyframe_db.py`` (numpy; the port imports nothing
of the JAX package).  Replaces src/vslam/src/KeyFrameDatabase.cc.  The inverted file becomes a
dense [K, W] tf-idf matrix (scoring all keyframes = one matvec — the MXU-era
answer to per-word posting lists), but the candidate-selection logic keeps
the reference's structure, including its RELAXED thresholds vs stock
ORB-SLAM2: minCommonWords = 0.6*max (KeyFrameDatabase.cc:129), group-score
retain factor 0.55 (:184); relocalization uses 0.8/0.75 (:248, :303).
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from asdslam_torch.config import SlamConfig


class KeyFrameDatabase:
    def __init__(self, cfg: SlamConfig, n_words: int, max_kfs: int):
        self.cfg = cfg
        self.n_words = n_words
        self.bow = np.zeros((max_kfs, n_words), np.float32)
        self.occ = np.zeros((max_kfs, n_words), bool)
        self.present = np.zeros(max_kfs, bool)

    def add(self, kf: int, bow_vec: np.ndarray):
        while kf >= len(self.present):  # track MapStore keyframe growth
            self.bow = np.concatenate([self.bow, np.zeros_like(self.bow)])
            self.occ = np.concatenate([self.occ, np.zeros_like(self.occ)])
            self.present = np.concatenate(
                [self.present, np.zeros_like(self.present)])
        self.bow[kf] = bow_vec
        self.occ[kf] = bow_vec > 0
        self.present[kf] = True

    def erase(self, kf: int):
        self.present[kf] = False

    def _candidates(self, query_bow, exclude: Set[int], min_score: float,
                    common_factor: float, retain_factor: float,
                    covis_of, top_groups: int = 10,
                    restrict_mask=None) -> List[int]:
        qocc = query_bow > 0
        mask = self.present.copy()
        if restrict_mask is not None:
            # only_global_map filter (KeyFrameDatabase.cc:146,229):
            # localization mode matches against PRIOR-map keyframes only
            n = min(len(mask), len(restrict_mask))
            mask[:n] &= restrict_mask[:n]
            mask[n:] = False
        for k in exclude:
            if 0 <= k < len(mask):
                mask[k] = False
        if not mask.any():
            return []
        common = self.occ[mask] @ qocc.astype(np.float32)
        ids = np.nonzero(mask)[0]
        if len(ids) == 0 or common.max() == 0:
            return []
        max_common = common.max()
        min_common = common_factor * max_common
        sel = common > max(min_common, 0)
        ids = ids[sel]
        if len(ids) == 0:
            return []
        scores = 1.0 - 0.5 * np.abs(self.bow[ids] - query_bow[None, :]).sum(axis=1)
        keep = scores >= min_score
        ids, scores = ids[keep], scores[keep]
        if len(ids) == 0:
            return []

        # group accumulation over covisible neighbourhoods
        score_of = dict(zip(ids.tolist(), scores.tolist()))
        best_acc = 0.0
        groups = []  # (acc_score, best_kf, best_individual_score)
        for k, s in score_of.items():
            acc = s
            best_kf, best_s = k, s
            for nb in covis_of(k)[:top_groups]:
                if nb in score_of:
                    acc += score_of[nb]
                    if score_of[nb] > best_s:
                        best_kf, best_s = nb, score_of[nb]
            groups.append((acc, best_kf, best_s))
            best_acc = max(best_acc, acc)
        th = retain_factor * best_acc
        out, seen = [], set()
        # order by the best member's INDIVIDUAL score: a true revisit with one
        # very strong match should be verified before clusters of mediocre
        # mutual matches with a larger accumulated score
        for acc, k, s in sorted(groups, key=lambda g: -g[2]):
            if acc >= th and k not in seen:
                seen.add(k)
                out.append(k)
        return out

    def detect_loop_candidates(self, kf: int, query_bow, covis_set: Set[int],
                               min_score: float, covis_of,
                               restrict_mask=None) -> List[int]:
        exclude = set(covis_set) | {kf}
        return self._candidates(
            query_bow, exclude, min_score,
            self.cfg.loop_bow_common_words, self.cfg.loop_bow_group_retain,
            covis_of, restrict_mask=restrict_mask)

    def detect_reloc_candidates(self, query_bow, covis_of,
                                restrict_mask=None) -> List[int]:
        return self._candidates(
            query_bow, set(), 0.0,
            self.cfg.reloc_bow_common_words, self.cfg.reloc_bow_group_retain,
            covis_of, restrict_mask=restrict_mask)
