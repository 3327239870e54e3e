"""Plain references of what the benchmark judges: the descriptor network,
the extraction stages in front of it, the masked top-2 search, and the
alignment of a trajectory to its ground truth.

Plain PyTorch and NumPy, written from the algorithms' definitions; nothing
of the program is imported and nothing the program made is taken: the
network's weights are read from the raw weights file, the images are the
benchmark's own frames.  Where a function takes the program's output, it
takes it only to judge it.

``dtype`` selects the precision a reference runs in: float32 (or float64)
for the reference itself, ``"fp8"`` for the control, the same arithmetic
with every operand of the convolutions and of the dot products rounded to
float8 e4m3, the step below the bfloat16 that the configuration states for
both.
"""

from __future__ import annotations

import importlib
import math
import pickle

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1e30
BN_EPS = 1e-5
# (kernel, in, out, stride) of the descriptor's conv tower: L2-Net/HardNet,
# ASD-SLAM's ASDNet/ASDNet.py:331-370
LAYERS = ((3, 1, 32, 1), (3, 32, 32, 1), (3, 32, 64, 2), (3, 64, 64, 1),
          (3, 64, 128, 2), (3, 128, 128, 1), (8, 128, 128, 1))


class _Arrays(pickle.Unpickler):
    """Unpickles numpy arrays and nothing else."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "_reconstruct")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not a numpy array type")
        if name == "_reconstruct":
            # numpy 2 writes numpy._core, numpy 1 reads numpy.core
            for mod in ("numpy._core.multiarray", "numpy.core.multiarray"):
                try:
                    return getattr(importlib.import_module(mod), name)
                except ImportError:
                    continue
        return getattr(np, name)


def load_weights(path: str) -> dict:
    """The weights file: ``conv`` (HWIO), ``bn_mean``, ``bn_var`` lists."""
    with open(path, "rb") as f:
        return _Arrays(f).load()


def _round(x, dtype):
    if dtype == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    return x


def describe(patches: torch.Tensor, weights: dict, dtype="f32") -> torch.Tensor:
    """[N, 32, 32] patches in [0, 1] -> [N, 128] unit descriptors: per-patch
    whitening (mean, unbiased std + 1e-7), seven convs with inference batch
    norm and ReLU between them ("SAME" padding, which pads a stride-2 conv
    by 0 before and 1 after; the last conv "VALID"), then L2 normalisation.
    f32 throughout (TF32 off); "fp8" rounds each conv's operands and each
    layer's output to float8."""
    dev = patches.device
    x = patches[:, None].to(torch.float32)
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[1]
    mean = flat.mean(dim=1)
    std = torch.sqrt(((flat - mean[:, None]) ** 2).sum(dim=1) / (n - 1)) + 1e-7
    x = (x - mean[:, None, None, None]) / std[:, None, None, None]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for i, (ks, _cin, _cout, stride) in enumerate(LAYERS):
            w = torch.from_numpy(np.asarray(weights["conv"][i], np.float32)).to(dev)
            w = w.permute(3, 2, 0, 1).contiguous()
            if stride == 2:
                x, pad = F.pad(x, (0, 1, 0, 1)), 0
            else:
                pad = 0 if ks == 8 else 1
            x = F.conv2d(_round(x, dtype), _round(w, dtype), stride=stride, padding=pad)
            var = torch.from_numpy(np.asarray(weights["bn_var"][i], np.float32)).to(dev)
            mu = torch.from_numpy(np.asarray(weights["bn_mean"][i], np.float32)).to(dev)
            scale = 1.0 / torch.sqrt(var + BN_EPS)
            x = (x - mu[:, None, None]) * scale[:, None, None]
            if i < len(LAYERS) - 1:
                x = torch.relu(x)
            x = _round(x, dtype)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    d = x.reshape(x.shape[0], -1)
    return d / torch.sqrt((d * d).sum(dim=1, keepdim=True) + 1e-10)


# --------------------------------------------------------------------------- #
# Extraction: the pyramid, the blur and the patches, in float64
# --------------------------------------------------------------------------- #
def level_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    return [(int(round(h / scale_factor ** i)), int(round(w / scale_factor ** i)))
            for i in range(n_levels)]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of a linear resize with a triangle filter
    widened by the downscale factor (antialiased), each column normalised
    to sum 1; samples at (j + 0.5) * n_in / n_out - 0.5."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / width
    w = np.maximum(0.0, 1.0 - x)
    return w / w.sum(axis=0, keepdims=True)


def pyramid(image: torch.Tensor, n_levels: int, scale_factor: float):
    """Each level resized from the one before it (float64)."""
    h, w = image.shape
    levels = [image.to(torch.float64)]
    for sh in level_shapes(h, w, n_levels, scale_factor)[1:]:
        prev = levels[-1]
        wh = torch.from_numpy(resize_weights(prev.shape[0], sh[0])).to(image.device)
        ww = torch.from_numpy(resize_weights(prev.shape[1], sh[1])).to(image.device)
        levels.append((wh.T @ prev) @ ww)
    return levels


def blur(image: torch.Tensor, sigma: float = 2.0, ksize: int = 7) -> torch.Tensor:
    """7-tap Gaussian (sigma 2) along rows then columns, edges replicated."""
    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float64, device=image.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    H, W = image.shape
    p = torch.cat([image[:1].expand(r, W), image, image[-1:].expand(r, W)], 0)
    out = sum(k[i] * p[i:i + H] for i in range(ksize))
    p = torch.cat([out[:, :1].expand(H, r), out, out[:, -1:].expand(H, r)], 1)
    return sum(k[i] * p[:, i:i + W] for i in range(ksize))


def patches_at(image_u8: np.ndarray, uv: np.ndarray, level: np.ndarray, n_levels: int,
               scale_factor: float, device, size: int = 32) -> torch.Tensor:
    """[K, size, size] float32 patches of the blurred pyramid level of each
    keypoint, the patch's corner at the keypoint's level pixel minus half a
    patch, clamped inside the level.  ``uv`` are full-resolution pixel
    positions of keypoints found on the level's integer grid."""
    img = torch.from_numpy(image_u8).to(device).to(torch.float64) / 255.0
    levels = pyramid(img, n_levels, scale_factor)
    out = torch.empty((len(uv), size, size), dtype=torch.float64, device=device)
    half = size // 2
    r = torch.arange(size, device=device)
    for li, lev in enumerate(levels):
        sel = np.flatnonzero(level == li)
        if not len(sel):
            continue
        xy = np.rint(uv[sel] / scale_factor ** li).astype(np.int64)
        H, W = lev.shape
        x0 = torch.from_numpy(np.clip(xy[:, 0] - half, 0, W - size)).to(device)
        y0 = torch.from_numpy(np.clip(xy[:, 1] - half, 0, H - size)).to(device)
        b = blur(lev)
        out[torch.from_numpy(sel).to(device)] = b[(y0[:, None] + r)[:, :, None],
                                                  (x0[:, None] + r)[:, None, :]]
    return out.to(torch.float32)


# --------------------------------------------------------------------------- #
# The masked top-2 search
# --------------------------------------------------------------------------- #
def gate(valid_a, valid_b, uv_a, uv_b, rad2, levels_a, levels_b, level_window):
    """[N, M] bool: the pairs within the row's squared radius (float32, each
    operation rounded on its own), valid on both sides, and with the level
    difference b - a inside the window."""
    dx = uv_a[:, None, 0] - uv_b[None, :, 0]
    dy = uv_a[:, None, 1] - uv_b[None, :, 1]
    d2 = dx * dx
    d2 = d2 + dy * dy
    ld = (levels_b[None, :] - levels_a[:, None]).to(torch.float32)
    return ((d2 <= rad2[:, None]) & valid_a[:, None] & valid_b[None, :]
            & (ld >= level_window[0]) & (ld <= level_window[1]))


def distances(desc_a, desc_b, dtype="f64"):
    """[N, M] squared distances |a|^2 + |b|^2 - 2 a.b, clamped at 0: float64,
    or with the dot's operands rounded to float8 ("fp8")."""
    a = desc_a.to(torch.float64)
    b = desc_b.to(torch.float64)
    a2, b2 = (a * a).sum(1), (b * b).sum(1)
    if dtype == "fp8":
        a = desc_a.to(torch.float8_e4m3fn).to(torch.float64)
        b = desc_b.to(torch.float8_e4m3fn).to(torch.float64)
    return torch.clamp(a2[:, None] + b2[None, :] - 2.0 * (a @ b.T), min=0.0)


def top2(dist, ok):
    """(idx, best, second) of each row over the gated pairs, BIG where none:
    the first-occurrence argmin and the least over the other columns."""
    d = torch.where(ok, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=1)
    best = d.gather(1, idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols[None, :] == idx[:, None], torch.full_like(d, BIG), d).amin(1)
    return idx, best, second


# --------------------------------------------------------------------------- #
# Trajectories
# --------------------------------------------------------------------------- #
def centres(pose7: np.ndarray) -> np.ndarray:
    """Camera centres -R_cw^T t_cw of packed T_cw poses (qw, qx, qy, qz, t)."""
    q = pose7[:, :4].astype(np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)
    return -np.einsum("nji,nj->ni", R, pose7[:, 4:].astype(np.float64))


def _umeyama(est: np.ndarray, gt: np.ndarray):
    """(s, R, mu_e, mu_g) of the least-squares similarity that maps the
    estimated centres onto the ground truth, gt ~ s R (est - mu_e) + mu_g
    (Umeyama 1991)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    cov = g.T @ e / len(est)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    var_e = (e ** 2).sum() / len(est)
    s = np.trace(np.diag(S) @ D) / var_e if var_e > 0 else 0.0
    return s, R, mu_e, mu_g


def sim3_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS distance between the ground-truth centres and the estimated ones
    after the least-squares similarity that maps the estimate onto the
    ground truth."""
    s, R, mu_e, mu_g = _umeyama(est, gt)
    aligned = s * (est - mu_e) @ R.T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


def loop_gap(loops, est: dict, gt: np.ndarray) -> float:
    """The loops' closure error as a share of their laps.  ``est`` holds
    the judged centres by frame ({frame: centre}: every keyframe's, or every
    frame's), ``gt`` the true centre of every frame of the stream.  For each
    loop (f0, f1), f0 the matched keyframe's frame and f1 the loop
    keyframe's, the lap is the frames of ``est`` from f0 to f1; their centres
    ``c`` are fitted onto the true ones ``g`` by a similarity (s, R), and the
    gap is |s R (c[f1] - c[f0]) - (g[f1] - g[f0])| over the true path length
    from f0 to f1.  The largest over the loops; inf where there is no loop,
    where f0 or f1 has no centre, or where a lap holds fewer than three."""
    if not loops:
        return math.inf
    g_all = np.asarray(gt, np.float64)
    worst = 0.0
    for f0, f1 in loops:
        a, b = min(f0, f1), max(f0, f1)
        frames = [f for f in sorted(est) if a <= f <= b]
        if a not in est or b not in est or len(frames) < 3 or b >= len(g_all):
            return math.inf
        c = np.stack([np.asarray(est[f], np.float64) for f in frames])
        g = g_all[frames]
        length = float(np.linalg.norm(np.diff(g_all[a:b + 1], axis=0), axis=1).sum())
        if not length > 0:
            return math.inf
        s, R, _, _ = _umeyama(c, g)
        gap = float(np.linalg.norm(s * R @ (c[-1] - c[0]) - (g[-1] - g[0])))
        worst = max(worst, gap / length)
    return worst
