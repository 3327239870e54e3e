"""Helpers of the harness's CPU tests: a small configuration of a cell, the
kernel's route on CPU tensors, and the faults that a run must catch.

On the CPU the program's projection searches take the distance-matrix path
and never reach K1's wrapper; ``kernel_route`` sends them through the
wrapper, whose CPU body is the kernel's plain version, as on the card, so
that the probe sees and the check judges them.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


# the camera's scale of a small run: the smaller image moves a few pixels a
# frame at 0.35; the lens camera's slower flight needs 0.5
SCALE = {"kitti": 0.35, "euroc": 0.5}


def small(workload: str):
    """(slam overrides, traffic overrides): the cell's camera scaled by
    ``SCALE``, 500 features on 4 levels, a keyframe at least every 3 frames,
    and a short stream, so that a run fits a CPU test."""
    import run
    config = run.cell_of(run.load_json("BENCHMARK.json"), workload)["config"]
    s = run.load_json("slambench", "configs", config + ".json")["slam"]
    scale = SCALE.get(config, 0.5)
    slam = dict(image_width=int(round(s["image_width"] * scale)),
                image_height=int(round(s["image_height"] * scale)),
                fx=s["fx"] * scale, fy=s["fy"] * scale, cx=s["cx"] * scale, cy=s["cy"] * scale,
                n_features=500, n_levels=4, max_step_kf=3)
    return slam, {"warmup_frames": 20, "max_fps": 8}


@contextlib.contextmanager
def kernel_route():
    """``match.search_projection`` through K1's wrapper on CPU tensors."""
    from asdslam_torch.ops import masked_nn as mnn
    from asdslam_torch.ops import match

    orig = match.search_projection

    def search_projection(desc_a, desc_b, uv_proj_a, uv_b, valid_a, valid_b, radius_a,
                          max_dist, ratio, pred_level_a=None, levels_b=None, level_window=1,
                          skip_b=None, use_kernel=True):
        if not use_kernel:
            return orig(desc_a, desc_b, uv_proj_a, uv_b, valid_a, valid_b, radius_a, max_dist,
                        ratio, pred_level_a, levels_b, level_window, skip_b, use_kernel)
        n = desc_a.shape[0]
        vb = valid_b if skip_b is None else (valid_b & ~skip_b)
        r = torch.as_tensor(radius_a, dtype=torch.float32).expand(n).contiguous()
        lw = ((-float(level_window), float(level_window)) if pred_level_a is not None
              else (-1e9, 1e9))
        idx, best, second = mnn.masked_nn(desc_a.to(torch.float32), desc_b.to(torch.float32),
                                          valid_a, vb, uv_proj_a, uv_b, r * r, pred_level_a,
                                          levels_b, lw)
        ok = best <= max_dist
        if ratio < 1.0:
            ok = ok & (best < ratio * second)
        idx = idx.to(torch.int64)
        return idx, best, match.resolve_duplicates(idx, best, ok, desc_b.shape[0])

    match.search_projection = search_projection
    try:
        yield
    finally:
        match.search_projection = orig


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def fault(kind: str):
    """A context manager that breaks the timed path underneath the harness:

    - "state_unchanged": the fused step's fetched pose is the first one it
      ever fetched, on every frame;
    - "answer_altered": K1 returns every seventh row's best distance 0.05
      higher than it found it;
    - "descriptor_altered": the descriptor network turns every fifth
      descriptor by a small rotation;
    - "half_batch": the network describes the first half of the patches
      and gives the rest their mean descriptor."""
    from asdslam_torch.frontend import tracking
    from asdslam_torch.models import asdnet
    from asdslam_torch.ops import masked_nn

    if kind == "state_unchanged":
        def make(orig):
            first = []

            def fetch(res):
                out = orig(res)
                if not first:
                    first.append(out[0].copy())
                return (first[0].copy(),) + tuple(out[1:])
            return fetch
        return patched(tracking, "_fetch_small", make)
    if kind == "answer_altered":
        def make(orig):
            def run(args, level_window):
                idx, best, second = orig(args, level_window)
                best = best.clone()
                best[::7] += 0.05
                return idx, best, second
            return run
        return patched(masked_nn, "_run", make)
    if kind in ("descriptor_altered", "half_batch"):
        def make(orig):
            def forward(self, patches, *a, **kw):
                if kind == "half_batch":
                    h = patches.shape[0] // 2
                    d = orig(self, patches[:h], *a, **kw)
                    m = d.mean(0, keepdim=True)
                    m = m / torch.linalg.norm(m)
                    return torch.cat([d, m.expand(patches.shape[0] - h, -1)], 0)
                d = orig(self, patches, *a, **kw).clone()
                d[::5] = torch.roll(d[::5], 1, dims=1) * 0.2 + d[::5]
                return d / torch.linalg.norm(d, dim=1, keepdim=True)
            return forward
        return patched(asdnet.ASDNet, "forward", make)
    raise ValueError(kind)


FAULTS = ("state_unchanged", "answer_altered", "descriptor_altered", "half_batch")
