"""Concurrent multi-sequence tracking: the per-frame tracking step over a
batch of sequences, the batch split over the device mesh.

Port of ``asdslam_tpu/parallel/multi_seq.py``.  Scaling the step is pure
data parallelism: each shard tracks its own subset of sequences and no
per-sequence state crosses shards, so nothing is reduced
(``mesh.reduced_elems`` does not move).  As the reference vmaps the step
and runs it under ``shard_map``, each shard runs its sequences as one
batched step (``track_step.make_batched_track_step``: ``torch.func.vmap``
of the single step, one CUDA graph per shard and batch size on the card),
so the masked-NN search is launched three times a frame per shard, each
launch with a batch grid axis over the shard's sequences.  Shards that
share a card run one after another.
"""

from __future__ import annotations

import torch

from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend import track_step as track_step_mod
from asdslam_torch.parallel.dist import Mesh


def _take(x, b, device):
    """Sequence ``b`` (an index or a slice) of a (nested) NamedTuple of
    batched tensors."""
    if isinstance(x, tuple):
        return type(x)(*(_take(f, b, device) for f in x))
    return x[b].to(device)


def _cat(items, device):
    """The shards' blocks of a (nested) NamedTuple joined along the leading
    sequence axis, on ``device``."""
    if isinstance(items[0], tuple):
        return type(items[0])(*(_cat([it[j] for it in items], device)
                                for j in range(len(items[0]))))
    return torch.cat([t.to(device) for t in items])


def make_dp_track_step(cfg: SlamConfig, K, extract_fn, mesh: Mesh):
    """Build a batched tracking step: every argument and result gains a
    leading sequence axis, split over ``mesh``'s shards.

    ``extract_fn``: one extractor for every shard, or a dict from each
    shard's device to the extractor whose weights live there (shards on
    distinct cards).

    Call with (imgs [B, H, W], poses [B, 7], velocities [B, 7], prev_feats
    (FrameFeatures with leading B), prev_geom (GeomBlock, leading B),
    cand_pts (PointBlock, leading B)[, prev_crow [B, N]]); B must be
    divisible by the mesh size.  Returns (feats, TrackResult) with a leading
    axis over this process's sequences (all B on a one-process mesh), on
    the first shard's device; sequence b's result is the single-sequence
    step's on sequence b's inputs, bit for bit."""
    steps = []
    for d in mesh.devices:
        fn = extract_fn[d] if isinstance(extract_fn, dict) else extract_fn
        steps.append(track_step_mod.make_batched_track_step(cfg, K, fn, device=d))

    def run(imgs, poses, velocities, prev_feats, prev_geom, cand_pts, prev_crow=None):
        B = len(imgs)
        if B % mesh.size:
            raise ValueError(f"{B} sequences do not split over a mesh of {mesh.size}")
        per = B // mesh.size
        feats, results = [], []
        for i, (d, step) in enumerate(zip(mesh.devices, steps)):
            block = slice((mesh.first + i) * per, (mesh.first + i + 1) * per)
            state = [_take(x, block, d)
                     for x in (poses, velocities, prev_feats, prev_geom, cand_pts)]
            crow = None if prev_crow is None else prev_crow[block].to(d)
            feat, res = step(torch.as_tensor(imgs[block]).to(d), *state, crow)
            feats.append(feat)
            results.append(res)
        return _cat(feats, mesh.devices[0]), _cat(results, mesh.devices[0])

    run.steps = steps  # each shard's batched step (its .eager, its .graphs)
    return run
