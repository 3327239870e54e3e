"""FAST-9 corner score, 3x3 NMS and grid-uniform top-k selection.

Port of ``asdslam_tpu/ops/fast.py`` (the reference's OpenCV FAST + quadtree
distribution, ORBextractor.cc:817-1083, replaced by per-cell ranking: each
``cell_size`` cell contributes at most ``cell_cap`` corners before a global
top-k by score).

Tie order matters where scores are equal, and zero scores are common: the
per-cell passes use ``torch.argmax`` (first occurrence, as ``jnp.argmax``) and
the global top-k uses a stable descending sort, which keeps the lower index
first as ``jax.lax.top_k`` does (``torch.topk`` does not).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, circular order, as (dy, dx).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _window_min(d, n):
    """Circular sliding-window min of length n along dim 0, by doubling; the
    final overlapping roll covers the remainder (overlap is harmless)."""
    mins = d
    size = 1
    while size * 2 <= n:
        mins = torch.minimum(mins, torch.roll(mins, -size, dims=0))
        size *= 2
    if size < n:
        mins = torch.minimum(mins, torch.roll(mins, -(n - size), dims=0))
    return mins


def fast_score(image: torch.Tensor, arc_length: int = 9) -> torch.Tensor:
    """Per-pixel FAST-9 score: the largest threshold for which the pixel is
    still a corner (max over arcs of the min brightness difference).
    image: [H, W] float32 -> [H, W]."""
    H, W = image.shape
    pad = 3
    padded = F.pad(image[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    diffs = torch.stack(
        [padded[pad + dy:pad + dy + H, pad + dx:pad + dx + W] - image
         for (dy, dx) in _CIRCLE],
        dim=0,
    )  # [16, H, W]
    bright = _window_min(diffs, arc_length)
    dark = _window_min(-diffs, arc_length)
    return torch.maximum(bright.amax(dim=0), dark.amax(dim=0))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression.  Plateau ties are broken in raster order:
    strict > against earlier neighbours, >= against later ones, so exactly one
    pixel of a tied plateau survives."""
    padded = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    H, W = score.shape
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            n = padded[dy:dy + H, dx:dx + W]
            earlier = (dy < 1) or (dy == 1 and dx < 1)
            keep = keep & ((score > n) if earlier else (score >= n))
    return torch.where(keep, score, torch.zeros_like(score))


def _cells(x, ncy, ncx, cell_size):
    return (x.reshape(ncy, cell_size, ncx, cell_size).permute(0, 2, 1, 3)
            .reshape(ncy * ncx, cell_size * cell_size))


def detect_level(
    image: torch.Tensor,
    threshold: float,
    min_threshold: float,
    max_keypoints: int,
    cell_size: int = 30,
    cell_cap: int = 4,
    border: int = 16,
):
    """Detect up to ``max_keypoints`` FAST corners on one pyramid level.

    Returns (xy [K, 2] float32 (x, y) in level coords, score [K], valid [K]).
    Cells with no corner above ``threshold`` fall back to ``min_threshold``
    (iniThFAST=20 -> minThFAST=7, ORBextractor.cc:817-864); each cell
    contributes at most ``cell_cap`` corners."""
    H, W = image.shape
    dev = image.device
    score = nms3(fast_score(image))

    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    in_border = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    score = torch.where(in_border, score, torch.zeros_like(score))

    ncy = -(-H // cell_size)
    ncx = -(-W // cell_size)
    pad = (0, ncx * cell_size - W, 0, ncy * cell_size - H)
    s_pad = F.pad(score, pad)
    cells_s = _cells(s_pad, ncy, ncx, cell_size)
    cells_hi = cells_s > threshold
    cells_lo = cells_s > min_threshold

    # Per cell: the hi-threshold corners, or the lo ones if it has none.
    cell_has_hi = cells_hi.any(dim=1, keepdim=True)
    use = torch.where(cell_has_hi, cells_hi, cells_lo)
    work = torch.where(use, cells_s, torch.zeros_like(cells_s))

    # Per-cell top-`cell_cap` by `cell_cap` argmax passes (first occurrence).
    cap_s, cap_i = [], []
    ccols = torch.arange(work.shape[1], device=dev)
    for _ in range(cell_cap):
        ci = torch.argmax(work, dim=1)
        cap_s.append(torch.gather(work, 1, ci[:, None])[:, 0])
        cap_i.append(ci)
        work = torch.where(ccols[None, :] == ci[:, None],
                           torch.full_like(work, float("-inf")), work)
    cap_scores = torch.stack(cap_s, dim=1)  # [C, cap]
    cap_idx = torch.stack(cap_i, dim=1)

    cell_ids = torch.arange(ncy * ncx, device=dev)[:, None]
    gy = (cell_ids // ncx) * cell_size + cap_idx // cell_size
    gx = (cell_ids % ncx) * cell_size + cap_idx % cell_size

    flat_scores = cap_scores.reshape(-1)
    # Global top-k, ties to the lower index (jax.lax.top_k's order).
    k = min(max_keypoints, flat_scores.shape[0])
    sorted_s, order = torch.sort(flat_scores, descending=True, stable=True)
    top_scores, top_i = sorted_s[:k], order[:k]
    sel_y = gy.reshape(-1)[top_i]
    sel_x = gx.reshape(-1)[top_i]
    valid = top_scores > 0.0

    xy = torch.stack([sel_x, sel_y], dim=-1).to(torch.float32)
    if k < max_keypoints:
        padk = max_keypoints - k
        xy = torch.cat([xy, xy.new_zeros((padk, 2))], dim=0)
        top_scores = torch.cat([top_scores, top_scores.new_zeros((padk,))], dim=0)
        valid = torch.cat([valid, valid.new_zeros((padk,))], dim=0)
    return xy, top_scores, valid
