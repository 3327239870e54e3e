"""Descriptor matching on distance matrices, plus the fused projection search.

Port of the matchers of ``asdslam_tpu/ops/match.py`` (the
reference's ORBmatcher, ORBmatcher.cc): squared L2 via |a|^2 + |b|^2 - 2 a.b
with the cross term in bf16 and f32 accumulation, gates as an additive +inf
mask, best/second for the ratio test, duplicate resolution, and the 30-bin
rotation histogram keeping the 3 fullest bins (CheckOrientation).

``search_projection`` on a CUDA device goes through the hand-written masked
nearest-neighbour kernel (``ops/masked_nn.py``), which never writes the
[N, M] matrix; elsewhere, or with ``use_kernel=False``, it takes the
distance-matrix path, as the reference does off the TPU.

Match indices come back as int64 (torch's index type); the reference's are
int32 with the same values.
"""

from __future__ import annotations

import math

import torch

from asdslam_torch.ops import masked_nn as masked_nn_mod

INF = float("inf")


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [N, M] between descriptor rows.  The cross term
    multiplies bf16-rounded inputs and sums in f32 (each product of two bf16
    values is exact in f32); the norm terms stay f32."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    a2 = torch.sum(af * af, dim=-1, keepdim=True)
    b2 = torch.sum(bf * bf, dim=-1, keepdim=True)
    ab = a.to(torch.bfloat16).to(torch.float32) @ b.to(torch.bfloat16).to(torch.float32).T
    return torch.clamp(a2 + b2.T - 2.0 * ab, min=0.0)


def ratio_guard(x):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, 1e30))


def nn_match(dist: torch.Tensor, max_dist: float, ratio: float = 1.0, mutual: bool = False):
    """Row-wise nearest neighbour with Lowe ratio test.

    dist: [N, M] (masked entries = +inf).
    Returns (match_idx [N] int64, match_dist [N], valid [N] bool)."""
    bi = torch.argmin(dist, dim=1)  # first occurrence, as jnp.argmin
    best = torch.gather(dist, 1, bi[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    second = torch.where(cols[None, :] == bi[:, None], INF, dist).amin(dim=1)
    ok = best <= max_dist
    if ratio < 1.0:
        # +inf second (no other candidate) passes the ratio test
        ok = ok & (best < ratio * ratio_guard(second))
    if mutual:
        col_best = torch.argmin(dist, dim=0)
        ok = ok & (col_best[bi] == torch.arange(dist.shape[0], device=dist.device))
    return bi, best, ok


def resolve_duplicates(match_idx, match_dist, valid, m_size: int):
    """Keep only the best row for each matched column, ties to the lowest
    row.  Both reductions are ``amin`` scatters, whose result does not
    depend on the order the rows arrive in.  Returns the updated mask."""
    idx = match_idx.to(torch.int64)
    big = torch.where(valid, match_dist, INF)
    col_min = torch.full((m_size,), INF, dtype=big.dtype, device=big.device)
    col_min = col_min.scatter_reduce(0, idx, big, "amin")
    is_best = big <= col_min[idx]
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)
    best_row = torch.full((m_size,), n, dtype=torch.int64, device=idx.device)
    best_row = best_row.scatter_reduce(
        0, idx, torch.where(is_best & valid, rows, n), "amin")
    return valid & is_best & (best_row[idx] == rows)


def _top_indices(x, k):
    """Indices of the k largest entries, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def rotation_consistency(angles_a, angles_b, match_idx, valid,
                         histo_length: int = 30, keep_bins: int = 3):
    """Rotation-histogram filter (CheckOrientation): bin the angle
    differences of valid matches and keep the matches in the ``keep_bins``
    fullest bins.  Equal counts go to the lower bin."""
    rot = torch.remainder(angles_a - angles_b[match_idx.to(torch.int64)], 2.0 * math.pi)
    bins = torch.floor(rot * (histo_length / (2.0 * math.pi))).to(torch.int64)
    bins = torch.clamp(bins, 0, histo_length - 1)
    hist = torch.zeros(histo_length, dtype=torch.int64, device=bins.device)
    hist = hist.index_add(0, bins, valid.to(torch.int64))  # integer sums: order-free
    top_bins = _top_indices(hist, keep_bins)
    return valid & (bins[:, None] == top_bins[None, :]).any(dim=1)


def window_mask(uv_a, uv_b, radius, valid_a=None, valid_b=None):
    """[N, M] additive mask: 0 where |uv_a_i - uv_b_j| <= radius else +inf.
    ``radius`` may be a scalar or per-row [N]."""
    d = uv_a[:, None, :] - uv_b[None, :, :]
    if isinstance(radius, torch.Tensor):
        r = radius.to(device=uv_a.device, dtype=torch.float32)
        r2 = (r * r) if r.ndim == 0 else (r * r)[:, None]
    else:
        # a number: squared in f32 on the host, as the device would square
        # it (a host-to-device copy could not be captured)
        r = torch.tensor(radius, dtype=torch.float32)
        r2 = float(r * r)
    inside = torch.sum(d * d, dim=-1) <= r2
    if valid_a is not None:
        inside = inside & valid_a[:, None]
    if valid_b is not None:
        inside = inside & valid_b[None, :]
    return torch.where(inside, 0.0, INF)


def epipolar_mask(F12, uv1, uv2, inv_sigma2_2, chi2_th: float = 3.84):
    """[N, M] additive mask keeping pairs whose point-to-epipolar-line distance
    in image 2 passes the chi2 gate (ORBmatcher::CheckDistEpipolarLine)."""
    h1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=1)
    h2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=1)
    l2 = h1 @ F12.T                      # lines in image 2, [N, 3]
    num = (l2 @ h2.T) ** 2               # [N, M]
    den = (l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None]
    dsqr = num / torch.clamp(den, min=1e-12)
    ok = dsqr * inv_sigma2_2[None, :] < chi2_th
    return torch.where(ok, 0.0, INF)


def fundamental_from_poses(K, R1, t1, R2, t2):
    """F12 such that x2^T F12 x1 = 0 for poses T_1w, T_2w (world->cam)."""
    R12 = R2 @ R1.T
    t12 = t2 - torch.einsum("ij,j->i", R12, t1)
    zero = torch.zeros_like(t12[0])
    tx = torch.stack([
        torch.stack([zero, -t12[2], t12[1]]),
        torch.stack([t12[2], zero, -t12[0]]),
        torch.stack([-t12[1], t12[0], zero]),
    ])
    Kinv = torch.linalg.inv_ex(K).inverse
    return Kinv.T @ tx @ R12 @ Kinv


def level_mask(levels_a, levels_b, min_delta=-1, max_delta=1):
    """Scale-consistency gate: match only if level_b is in
    [level_a + min_delta, level_a + max_delta]."""
    d = levels_b[None, :] - levels_a[:, None]
    return torch.where((d >= min_delta) & (d <= max_delta), 0.0, INF)


def search_window(
    desc_a, desc_b, uv_a, uv_b, valid_a, valid_b,
    radius: float, max_dist: float, ratio: float,
    angles_a=None, angles_b=None,
    levels_a=None, levels_b=None,
    histo_length: int = 30,
    check_rotation: bool = False,
):
    """Windowed search: for each feature in A the best match in B within
    ``radius`` px of uv_a.  Returns (match_idx [N], match_dist [N], valid [N])."""
    dist = distance_matrix(desc_a, desc_b)
    dist = dist + window_mask(uv_a, uv_b, radius, valid_a, valid_b)
    if levels_a is not None:
        dist = dist + level_mask(levels_a, levels_b)
    idx, d, ok = nn_match(dist, max_dist, ratio)
    ok = resolve_duplicates(idx, d, ok, desc_b.shape[0])
    if check_rotation and angles_a is not None:
        ok = rotation_consistency(angles_a, angles_b, idx, ok, histo_length)
    return idx, d, ok


def search_projection(
    desc_a, desc_b, uv_proj_a, uv_b, valid_a, valid_b,
    radius_a, max_dist: float, ratio: float,
    pred_level_a=None, levels_b=None, level_window: int = 1,
    skip_b=None, use_kernel: bool = True,
):
    """Map-point -> frame projection search (SearchByProjection).

    A = projected candidates, B = current-frame features; ``radius_a`` is the
    per-candidate search radius; ``skip_b`` marks features already matched.
    On a CUDA device with ``use_kernel`` the best/second search is the fused
    masked-NN kernel (``skip_b`` folded into ``valid_b``, the ratio test
    against its finite BIG); otherwise the distance-matrix path.
    Returns (match_idx [N] int64, dist [N], valid [N])."""
    if use_kernel and desc_a.is_cuda:
        n = desc_a.shape[0]
        vb = valid_b if skip_b is None else (valid_b & ~skip_b)
        r = torch.as_tensor(radius_a, dtype=torch.float32, device=desc_a.device)
        r = r.expand(n).contiguous()
        lw = ((-float(level_window), float(level_window))
              if pred_level_a is not None else (-1e9, 1e9))
        # a bf16 descriptor block widens exactly; the kernel takes f32
        idx, best, second = masked_nn_mod.masked_nn(
            desc_a.to(torch.float32), desc_b.to(torch.float32), valid_a, vb,
            uv_proj_a, uv_b, r * r,
            pred_level_a, levels_b, lw)
        ok = best <= max_dist
        if ratio < 1.0:
            ok = ok & (best < ratio * second)  # masked second is BIG (finite)
        idx = idx.to(torch.int64)
        ok = resolve_duplicates(idx, best, ok, desc_b.shape[0])
        return idx, best, ok
    dist = distance_matrix(desc_a, desc_b)
    dist = dist + window_mask(uv_proj_a, uv_b, radius_a, valid_a, valid_b)
    if pred_level_a is not None:
        dist = dist + level_mask(pred_level_a, levels_b, -level_window, level_window)
    if skip_b is not None:
        dist = torch.where(skip_b[None, :], INF, dist)
    idx, d, ok = nn_match(dist, max_dist, ratio)
    ok = resolve_duplicates(idx, d, ok, desc_b.shape[0])
    return idx, d, ok


def _search_masked(dist, m_size, max_dist, ratio):
    idx, d, ok = nn_match(dist, max_dist, ratio)
    ok = resolve_duplicates(idx, d, ok, m_size)
    return idx, d, ok


def search_triangulation(
    desc1, desc2, uv1, uv2, valid1, valid2, F12, inv_sigma2_2,
    max_dist: float, ratio: float = 1.0,
):
    """Epipolar-constrained matching of unmatched features between two KFs
    (ORBmatcher::SearchForTriangulation without the BoW-node gating: the
    full distance matrix)."""
    dist = distance_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :]
    dist = torch.where(mask, dist, INF)
    dist = dist + epipolar_mask(F12, uv1, uv2, inv_sigma2_2)
    return _search_masked(dist, desc2.shape[0], max_dist, ratio)


def search_global(desc_a, desc_b, valid_a, valid_b, max_dist: float, ratio: float):
    """Unconstrained NN search with ratio test (the role of SearchByBoW,
    with the node gating dropped: a full [N, M] distance matrix)."""
    dist = distance_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    dist = torch.where(mask, dist, INF)
    return _search_masked(dist, desc_b.shape[0], max_dist, ratio)
