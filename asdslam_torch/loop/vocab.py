"""Hierarchical k-means vocabulary over 128-float descriptors, as dense
arrays with batched tree descent.

Port of ``asdslam_tpu/loop/vocab.py``, the replacement for DBoW2's
TemplatedVocabulary + the authors' FSift descriptor class (src/dbow2/): the
k-ary tree is stored as per-level centroid matrices (children of node n at
level l live at indices n*b .. n*b+b-1 of level l+1), so transforming a
frame's 2000 descriptors is `depth` batched gather+argmin steps.  Scoring
uses DBoW2's TF_IDF weighting with L1 scoring (s = 1 - 0.5*|v - w|_1 on
L1-normalized vectors).

Differences from the reference, none of them in results beyond rounding:

- ``train_vocab`` takes its random picks as an argument (``rand_idx``, one
  index vector per level) instead of drawing them from a key;
- Lloyd's per-node sums are exact: each descriptor is rounded to a fixed
  point of 2^-S (S chosen so no sum can overflow int64) and the integers
  are summed, so no summation order, and no atomic, can change a centroid;
  the reference sums in f32 in index order.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from asdslam_torch.utils import graphs


class Vocabulary(NamedTuple):
    levels: List[torch.Tensor]  # level l: [b^l, D] centroids (level 0 = root, unused)
    idf: torch.Tensor           # [W] inverse document frequency weights
    branching: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth


def draw_rand_idx(gen: torch.Generator, n: int, branching: int, depth: int):
    """The random centroid picks ``train_vocab`` takes: per level l (1-based)
    a [b^l] index vector into the n training descriptors, from ``gen``."""
    return [torch.randint(0, n, (branching ** level,), generator=gen)
            for level in range(1, depth + 1)]


def _segment_sum(values, seg, n_seg: int, frac_bits: int):
    """[n_seg, ...] sums of ``values`` rows by segment id ``seg``, exact up to
    the 2^-frac_bits rounding of each value: integer sums do not depend on
    their order."""
    scale = float(2 ** frac_bits)
    q = torch.round(values.to(torch.float64) * scale).to(torch.int64)
    out = torch.zeros((n_seg,) + values.shape[1:], dtype=torch.int64, device=values.device)
    out.index_add_(0, seg, q)
    return out.to(torch.float64) / scale


def _nearest_child(cents, parent, descs, n_parents: int, branching: int):
    """Child index (0..b-1) of the nearest centroid among each descriptor's
    parent's children (first on ties)."""
    cand = cents.reshape(n_parents, branching, -1)[parent]  # [N, b, D]
    d2 = torch.sum((cand - descs[:, None, :]) ** 2, dim=-1)
    return torch.argmin(d2, dim=1)


def train_vocab(descs, rand_idx, branching: int = 10, depth: int = 4,
                iters: int = 8) -> Vocabulary:
    """Hierarchical k-means.  descs: [N, D] training descriptors;
    rand_idx: ``depth`` index vectors (``draw_rand_idx``), the fallback
    centroids of empty parents."""
    N, D = descs.shape
    dev = descs.device
    descs = descs.to(torch.float32)
    # fixed-point bits for the exact sums: N * max|x| * 2^S < 2^62
    amax = max(float(descs.abs().max()), 1e-30)
    frac_bits = int(math.floor(62 - math.log2(N * amax))) - 1
    assign = torch.zeros(N, dtype=torch.int64, device=dev)  # node id at current level
    ones = torch.ones(N, dtype=torch.int64, device=dev)
    levels = [torch.zeros((1, D), dtype=torch.float32, device=dev)]
    for level in range(1, depth + 1):
        n_parents = branching ** (level - 1)
        n_nodes = branching ** level
        # init: stratified picks from each parent's own pool (sort-by-parent,
        # strided selection); empty parents fall back to random descriptors
        order = torch.argsort(assign, stable=True)
        counts = torch.zeros(n_parents, dtype=torch.int64, device=dev).index_add_(0, assign, ones)
        starts = torch.cumsum(counts, 0) - counts
        cc = torch.arange(branching, device=dev)
        pick_in_parent = (cc[None, :] * counts[:, None]) // branching
        pick_idx = starts[:, None] + torch.minimum(
            pick_in_parent, torch.clamp(counts[:, None] - 1, min=0))
        cents = descs[order[torch.clamp(pick_idx.reshape(-1), 0, N - 1)]]
        rand_cents = descs[rand_idx[level - 1].to(dev)]
        empty = (counts == 0)[:, None].expand(n_parents, branching).reshape(-1)
        cents = torch.where(empty[:, None], rand_cents, cents)

        for _ in range(iters):
            # each vector only competes among its parent's children
            new_assign = assign * branching + _nearest_child(cents, assign, descs,
                                                             n_parents, branching)
            sums = _segment_sum(descs, new_assign, n_nodes, frac_bits)
            cnts = torch.zeros(n_nodes, dtype=torch.int64, device=dev).index_add_(
                0, new_assign, ones).to(torch.float64)
            new_cents = (sums / torch.clamp(cnts[:, None], min=1.0)).to(torch.float32)
            cents = torch.where(cnts[:, None] > 0, new_cents, cents)
        # final assignment at this level
        assign = assign * branching + _nearest_child(cents, assign, descs, n_parents,
                                                     branching)
        levels.append(cents)

    W = branching ** depth
    counts = np.bincount(assign.cpu().numpy(), minlength=W)
    idf = torch.as_tensor(np.log(N / (counts + 1.0)).astype(np.float32)).to(dev)
    return Vocabulary(levels=levels, idf=idf, branching=branching, depth=depth)


def descend(levels, descs, branching: int, depth: int):
    """The leaf word of each descriptor: from the root, the nearest child
    at each level (jitted in the reference, vocab.py:85)."""
    node = torch.zeros(descs.shape[0], dtype=torch.int64, device=descs.device)
    for level in range(1, depth + 1):
        n_parents = branching ** (level - 1)
        node = node * branching + _nearest_child(levels[level], node, descs, n_parents,
                                                 branching)
    return node


# once per keyframe and per relocalization: replayed from a CUDA graph on
# the card
_descend = graphs.captured(descend, "bow_descend")


def transform(vocab: Vocabulary, descs, valid=None):
    """descs [N, D] -> word ids [N] (leaves, int64; -1 where not ``valid``)."""
    words = _descend(vocab.levels, descs.to(torch.float32), vocab.branching, vocab.depth)
    if valid is not None:
        words = torch.where(valid, words, -1)
    return words


def bow_vector(vocab: Vocabulary, words, n_words=None) -> np.ndarray:
    """word ids [N] (-1 = invalid) -> L1-normalized tf-idf vector [W] (numpy)."""
    W = n_words or vocab.n_words
    w = words.cpu().numpy() if isinstance(words, torch.Tensor) else np.asarray(words)
    w = w[w >= 0]
    v = np.zeros(W, np.float32)
    np.add.at(v, w, 1.0)
    v *= vocab.idf.cpu().numpy()
    s = v.sum()
    if s > 0:
        v /= s
    return v


def score_l1(v1: np.ndarray, v2: np.ndarray) -> float:
    """DBoW2 L1 score between L1-normalized vectors: in [0, 1]."""
    return float(1.0 - 0.5 * np.abs(v1 - v2).sum())


def save_vocab(vocab: Vocabulary, path: str):
    """Serialize to .npz in the JAX package's format (the stand-in for the
    reference's OpenCV-yml vocabulary file, TemplatedVocabulary.h:1347-1455)."""
    arrays = {"level_%d" % i: l.cpu().numpy() for i, l in enumerate(vocab.levels)}
    np.savez_compressed(
        path, idf=vocab.idf.cpu().numpy(),
        branching=np.int32(vocab.branching), depth=np.int32(vocab.depth),
        n_levels=np.int32(len(vocab.levels)), **arrays)


def load_vocab(path: str, device="cuda") -> Vocabulary:
    z = np.load(path)
    n = int(z["n_levels"])
    return Vocabulary(
        levels=[torch.as_tensor(z["level_%d" % i]).to(device) for i in range(n)],
        idf=torch.as_tensor(z["idf"]).to(device),
        branching=int(z["branching"]), depth=int(z["depth"]))
