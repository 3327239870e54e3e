"""ASDNet training: the adaptive-scale triplet loss with in-batch
hardest-negative mining, on the device.

Port of ``asdslam_tpu/models/train.py`` (itself the reference trainer's
protocol, ASDNet/ASDNet/ASDNet.py):

- ``l2_distance_matrix_sqrt`` and ``asd_loss``: the hardest in-batch negative
  per anchor, near-duplicates (< 0.008) masked, anchor swap; the adaptive
  log-sigmoid loss or the plain triplet margin;
- ``correlation_penalty`` and ``global_orthogonal_regularization``;
- ``augment_pair``: per-sample rot90 then column flip, then a random-resized
  crop (bilinear), the same transform on both members of a pair;
- ``train_step``: one SGD step (``c - lr * (g + 1e-4 c)`` on the convs, the
  running BN statistics from the anchor pass), the reference's jitted
  program as one CUDA graph on the card (``graphs.captured(..., grad=True)``:
  forward, backward and update); ``lr_schedule``, ``lr_table``, ``fpr95``;
- ``make_batch``: matched pairs cut from the synthetic texture world;
- the UBC PhotoTour readers (``load_phototour``, ``read_phototour_pairs``,
  ``phototour_batch``).

Randomness comes from explicit ``torch.Generator``s.  Each random function
is split into its draws (``draw_*``, a small named tuple) and a pure
function of them, so a test can hand it the JAX package's draws.  The convs
and their gradients are cuDNN's through autograd, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from asdslam_torch.models import asdnet
from asdslam_torch.utils import graphs


def l2_distance_matrix_sqrt(a, b, eps=1e-6):
    a2 = torch.sum(a * a, dim=1)[:, None]
    b2 = torch.sum(b * b, dim=1)[None, :]
    return torch.sqrt(torch.clamp(a2 + b2 - 2 * (a @ b.T), min=0.0) + eps)


def asd_loss(out_a, out_p, adaptive: bool, margin: float = 1.0, anchor_swap: bool = True):
    """loss_ASDNet parity (ASDNet.py:56-90)."""
    n = out_a.shape[0]
    d = l2_distance_matrix_sqrt(out_a, out_p) + 1e-8
    pos = torch.diagonal(d)
    off = d + torch.eye(n, device=d.device) * 10.0
    # mask near-duplicate negatives (distance < 0.008)
    off = off + torch.where(off < 0.008, 10.0, 0.0)
    min_neg = off.min(dim=1).values
    if anchor_swap:
        min_neg = torch.minimum(min_neg, off.min(dim=0).values)
    if adaptive:
        theta = torch.mean(min_neg + pos)
        alpha = torch.mean(min_neg) / torch.clamp(torch.mean(pos), min=1e-8)
        right = F.logsigmoid(alpha * (theta - pos))
        nege = F.logsigmoid(alpha * (min_neg - theta))
        loss = -(right + nege) / torch.clamp(alpha, min=1e-8)
    else:
        loss = torch.clamp(margin + pos - min_neg, min=0.0)
    return torch.mean(loss)


def correlation_penalty(x):
    """CorrelationPenaltyLoss parity (ASDNet.py:31-42)."""
    z = x - torch.mean(x, dim=0)
    cor = z.T @ z
    off = cor - torch.diag(torch.diagonal(cor))
    return torch.sqrt(torch.sum(off * off) + 1e-12) / x.shape[0]


def global_orthogonal_regularization(anchor, negative):
    """GOR parity (ASDNet.py:92-98)."""
    nd = torch.sum(anchor * negative, dim=1)
    dim = anchor.shape[1]
    return torch.mean(nd) ** 2 + torch.clamp(torch.mean(nd ** 2) - 1.0 / dim, min=0.0)


# --------------------------------------------------------------------------- #
# Augmentation
# --------------------------------------------------------------------------- #
class AugmentDraws(NamedTuple):
    rots: torch.Tensor     # [B] int64 in 0..3: quarter turns counter-clockwise
    flips: torch.Tensor    # [B] bool: mirror the columns after the turn
    scales: torch.Tensor   # [B] f32 in [0.7, 1): the crop's scale
    centres: torch.Tensor  # [B, 2] f32 in [-2, 2): the crop's centre offset (y, x)


def draw_augment(generator: torch.Generator, batch: int) -> AugmentDraws:
    """``augment_pair``'s draws, on the generator's device."""
    dev = generator.device
    rots = torch.randint(0, 4, (batch,), generator=generator, device=dev)
    flips = torch.rand((batch,), generator=generator, device=dev) < 0.5
    scales = 0.7 + 0.3 * torch.rand((batch,), generator=generator, device=dev)
    centres = -2.0 + 4.0 * torch.rand((batch, 2), generator=generator, device=dev)
    return AugmentDraws(rots, flips, scales, centres)


def _bilinear(img, gy, gx):
    """img [B, H, W] sampled at (gy, gx) [B, h, w] (already clipped inside
    the image), the reference's four-tap sum in its order."""
    B, H, W = img.shape
    y0 = torch.floor(gy).to(torch.int64)
    x0 = torch.floor(gx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy, wx = gy - y0, gx - x0
    flat = img.reshape(B, -1)

    def tap(y, x):
        return torch.gather(flat, 1, (y * W + x).reshape(B, -1)).reshape(y.shape)

    return (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x1) * (1 - wy) * wx
            + tap(y1, x0) * wy * (1 - wx) + tap(y1, x1) * wy * wx)


def augment_pair(a, p, draws: AugmentDraws):
    """Geometric augmentation of matched pairs [B, S, S] x2: flip / rot90 /
    random-resized-crop, the reference's TripletPhotoTour pipeline
    (ASDNet.py:234-329), the SAME transform on both members."""
    B, S, _ = a.shape
    idx = torch.arange(B, device=a.device)

    def rot_flip(img):
        turned = torch.stack([torch.rot90(img, k, dims=(1, 2)) for k in range(4)])[draws.rots, idx]
        return torch.where(draws.flips[:, None, None], torch.flip(turned, dims=(2,)), turned)

    # RandomResizedCrop: the scale and a centre jitter, bilinear back to SxS
    half = (S - 1) / 2.0
    coords = (torch.arange(S, dtype=torch.float32, device=a.device) - half) * draws.scales[:, None]
    gy = coords[:, :, None] + half + draws.centres[:, 0, None, None]
    gx = coords[:, None, :] + half + draws.centres[:, 1, None, None]
    gy = torch.clamp(gy, 0.0, S - 1.001).expand(B, S, S)
    gx = torch.clamp(gx, 0.0, S - 1.001).expand(B, S, S)
    return _bilinear(rot_flip(a), gy, gx), _bilinear(rot_flip(p), gy, gx)


# --------------------------------------------------------------------------- #
# The step
# --------------------------------------------------------------------------- #
class StepDraws(NamedTuple):
    augment: AugmentDraws
    mask_a: torch.Tensor   # [B, 128, 8, 8] bool: the anchor pass's dropout keep mask
    mask_p: torch.Tensor   # the positive pass's


def draw_step(generator: torch.Generator, batch: int) -> StepDraws:
    """``train_step``'s draws, on the generator's device."""
    return StepDraws(draw_augment(generator, batch),
                     asdnet.draw_dropout_mask(generator, batch),
                     asdnet.draw_dropout_mask(generator, batch))


# The weight decay of the reference's SGD update
WEIGHT_DECAY = 1e-4


def _train_step(model: asdnet.ASDNetTrain, batch_a, batch_p, lr, draws: StepDraws,
                adaptive: bool = True, decor: bool = True, gor: bool = True,
                augment: bool = True):
    """One SGD step on a batch of matched patch pairs [B, 32, 32] x2 with
    the learning rate ``lr`` (a 0-d tensor on the batch's device): the
    convs take ``c - lr * (g + 1e-4 c)``, the reference's update, in place;
    the running BN statistics move to the anchor pass's batch statistics,
    in place.  Returns the loss (a 0-d tensor on the device, not fetched).

    The gradients come from ``torch.autograd.grad``: inside a capture they
    are the graph's, and no ``.grad`` is left on the convs."""
    ba, bp = augment_pair(batch_a, batch_p, draws.augment) if augment else (batch_a, batch_p)
    out_a, stats = model(ba, train=True, dropout_mask=draws.mask_a)
    out_p, _ = model(bp, train=True, dropout_mask=draws.mask_p)
    loss = asd_loss(out_a, out_p, adaptive=adaptive)
    if decor:
        loss = loss + correlation_penalty(out_a)
    if gor:
        # against the positives rolled by one: random non-matching descriptors
        loss = loss + global_orthogonal_regularization(out_a, torch.roll(out_p, 1, dims=0))
    convs = list(model.conv)
    grads = torch.autograd.grad(loss, convs)
    with torch.no_grad():
        for c, g in zip(convs, grads):
            c.sub_(lr * (g + WEIGHT_DECAY * c))
    model.update_running_stats(stats)
    return loss.detach()


# The reference jits its step (asdslam_tpu/models/train.py:131) with
# adaptive / decor / gor / augment static: here they, and the model, are
# constant leaves of the key, so a run keeps at most two graphs (adaptive
# switches once); the batch, lr and the draws are inputs.
train_step = graphs.captured(_train_step, "train_step", grad=True)


def lr_schedule(step, total_steps, base_lr=10.0) -> float:
    """Linear decay to 0 (ASDNet.py:539-548), rounded as the reference's f32
    evaluation rounds it."""
    return float(np.float32(base_lr) * np.float32(max(0.0, 1.0 - step / total_steps)))


def lr_table(total_steps, base_lr, device):
    """``lr_schedule`` of every step as one f32 tensor on ``device``: step
    ``i``'s learning rate is ``lr_table(...)[i]``, a 0-d tensor, so that no
    step copies its rate from the host or keys a graph of its own."""
    return torch.tensor([lr_schedule(i, total_steps, base_lr) for i in range(total_steps)],
                        dtype=torch.float32, device=device)


def fpr95(dists_pos, dists_neg):
    """FPR at 95% recall (ErrorRateAt95Recall semantics, ASDNet.py:106-113)."""
    d = np.concatenate([np.asarray(dists_pos), np.asarray(dists_neg)])
    labels = np.concatenate([np.ones(len(dists_pos)), np.zeros(len(dists_neg))])
    order = np.argsort(d)
    labels = labels[order]
    cum = np.cumsum(labels)
    idx = int(np.argmax(cum >= 0.95 * labels.sum()))
    fp = np.sum(labels[:idx] == 0)
    tn = np.sum(labels[idx:] == 0)
    return float(fp) / max(float(fp + tn), 1.0)


# --------------------------------------------------------------------------- #
# Synthetic patch-pair source (PhotoTour is not available offline)
# --------------------------------------------------------------------------- #
CANVAS = 256


class BatchDraws(NamedTuple):
    uv: torch.Tensor         # [B, 2] f32 in [40, 216): the spot (x, y) on the canvas
    canvas_ids: torch.Tensor  # [B] int64 in 0..3
    noise_a: torch.Tensor    # [B, S, S] f32 standard normal: the anchors' pixel noise
    angles: torch.Tensor     # [B] f32 in [-0.4, 0.4): the positives' rotation
    scales: torch.Tensor     # [B] f32 in [0.8, 1.25): the positives' scale
    jitter: torch.Tensor     # [B, 2] f32 standard normal: the positives' shift
    noise_p: torch.Tensor    # [B, S, S] f32 standard normal: the positives' pixel noise


def draw_batch(generator: torch.Generator, batch_size: int, size: int = 32) -> BatchDraws:
    """``make_batch``'s draws, on the generator's device."""
    dev, g = generator.device, generator

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    return BatchDraws(uniform(40.0, CANVAS - 40.0, (batch_size, 2)),
                      torch.randint(0, 4, (batch_size,), generator=g, device=dev),
                      torch.randn((batch_size, size, size), generator=g, device=dev),
                      uniform(-0.4, 0.4, (batch_size,)), uniform(0.8, 1.25, (batch_size,)),
                      torch.randn((batch_size, 2), generator=g, device=dev),
                      torch.randn((batch_size, size, size), generator=g, device=dev))


def _canvases(device):
    """The four 256x256 textured canvases of ``make_batch``: the synthetic
    world's plane texture at 0.1 units a pixel, block scale 1.3, salts 0-3.
    Cells are ``floor(a / scale)`` with a true division, as the reference's
    op-by-op evaluation computes them: on the CPU, since a CUDA division by
    a scalar multiplies by its reciprocal."""
    from asdslam_torch.io.synthetic import _hash01

    a = torch.arange(CANVAS, dtype=torch.float32)[None, :].expand(CANVAS, CANVAS) * 0.1
    b = torch.arange(CANVAS, dtype=torch.float32)[:, None].expand(CANVAS, CANVAS) * 0.1
    out = []
    for salt in range(4):
        v = _hash01(torch.floor(a / 1.3).to(torch.int64), torch.floor(b / 1.3).to(torch.int64), salt)
        v2 = _hash01(torch.floor(a / (1.3 * 3.7)).to(torch.int64),
                     torch.floor(b / (1.3 * 3.7)).to(torch.int64), salt + 17)
        out.append(0.25 + 0.5 * (0.65 * v + 0.35 * v2))
    return torch.stack(out).to(device)


def make_batch(draws: BatchDraws, size: int = 32):
    """Matched patch pairs [B, size, size] x2 from the procedural texture
    world: a patch and a warped (shifted / rotated / scaled + noise) view of
    the same surface region, on the draws' device."""
    canvas = _canvases(draws.uv.device)
    half = (size - 1) / 2.0
    B = draws.uv.shape[0]
    ones = torch.ones(B, device=draws.uv.device)

    def crop(uv, angle, scale, noise):
        coords = (torch.arange(size, dtype=torch.float32, device=uv.device) - half)[None] * scale[:, None]
        gy, gx = coords[:, :, None], coords[:, None, :]
        ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
        sx = ca * gx - sa * gy + uv[:, 0, None, None]
        sy = sa * gx + ca * gy + uv[:, 1, None, None]
        sx = torch.clamp(sx, 0.0, CANVAS - 1.001)
        sy = torch.clamp(sy, 0.0, CANVAS - 1.001)
        v = _bilinear(canvas[draws.canvas_ids], sy, sx)
        return v + 0.02 * noise

    anchors = crop(draws.uv, 0.0 * ones, ones, draws.noise_a)
    positives = crop(draws.uv + draws.jitter, draws.angles, draws.scales, draws.noise_p)
    return anchors, positives


def write_pair_cache(path: str, n_pool: int, n_eval: int, seed: int = 0, chunk: int = 4096):
    """A ``--pairs_cache`` file of ``make_batch`` pairs (``pool_a``,
    ``pool_p``, ``eval_a``, ``eval_p``), drawn in chunks from a CPU
    generator seeded with ``seed``, so that any device trains on the same
    pool."""
    g = torch.Generator().manual_seed(seed)

    def pairs(n):
        got = [make_batch(draw_batch(g, min(chunk, n - i))) for i in range(0, n, chunk)]
        return (torch.cat([a for a, _ in got]).numpy(), torch.cat([p for _, p in got]).numpy())

    pool_a, pool_p = pairs(n_pool)
    eval_a, eval_p = pairs(n_eval)
    np.savez(path, pool_a=pool_a, pool_p=pool_p, eval_a=eval_a, eval_p=eval_p)


# --------------------------------------------------------------------------- #
# UBC PhotoTour (the reference's training set, ASDNet.py:119-195): the raw
# layout, read where a local copy exists (no network)
# --------------------------------------------------------------------------- #
def _load_bmp_gray(path: str) -> np.ndarray:
    """Minimal 8-bit (grayscale-palette) BMP decoder for PhotoTour tiles."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"BM":
        raise ValueError("not a BMP: %s" % path)
    off = int.from_bytes(buf[10:14], "little")
    w = int.from_bytes(buf[18:22], "little", signed=True)
    h = int.from_bytes(buf[22:26], "little", signed=True)
    bpp = int.from_bytes(buf[28:30], "little")
    if bpp != 8:
        raise ValueError("PhotoTour BMPs are 8-bit, got %d bpp" % bpp)
    stride = (w + 3) & ~3
    rows = np.frombuffer(buf, np.uint8, stride * abs(h), off)
    img = rows.reshape(abs(h), stride)[:, :w]
    if h > 0:  # bottom-up storage
        img = img[::-1]
    return img.astype(np.float32) / 255.0


def load_phototour(root: str, max_patches: int = None):
    """Load a PhotoTour sequence dir (liberty/notredame/yosemite): patches
    from the 16x16 grids of 64x64 in patches*.bmp, 3D-point ids from
    info.txt.  Returns (patches [N, 64, 64] float32, ids [N] int64)."""
    ids = np.loadtxt(os.path.join(root, "info.txt"), dtype=np.int64, usecols=(0,))
    n = len(ids) if max_patches is None else min(len(ids), max_patches)
    out = np.zeros((n, 64, 64), np.float32)
    i = 0
    for bmp in sorted(glob.glob(os.path.join(root, "patches*.bmp"))):
        if i >= n:
            break
        tile = _load_bmp_gray(bmp)
        gh, gw = tile.shape[0] // 64, tile.shape[1] // 64
        for r in range(gh):
            for c in range(gw):
                if i >= n:
                    break
                out[i] = tile[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64]
                i += 1
    return out[:i], ids[:i]


def read_phototour_pairs(root: str, name: str = "m50_100000_100000_0.txt"):
    """The 100k eval pair list: returns (idx1 [M], idx2 [M], is_match [M]),
    the FPR@95 protocol of the reference (ASDNet.py:503-537)."""
    tbl = np.loadtxt(os.path.join(root, name), dtype=np.int64)
    return tbl[:, 0], tbl[:, 3], tbl[:, 1] == tbl[:, 4]


def _phototour_points(ids: np.ndarray):
    """(order, starts, pts): ``ids`` sorted stably, the start of each 3D
    point's run, and the points that have two patches or more."""
    uniq = np.unique(ids)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    starts = np.searchsorted(sorted_ids, uniq)
    counts = np.searchsorted(sorted_ids, uniq, side="right") - starts
    return order, starts, np.nonzero(counts >= 2)[0]


def draw_phototour(generator: torch.Generator, ids: np.ndarray, batch_size: int) -> np.ndarray:
    """``phototour_batch``'s draws: [batch_size] picks among the 3D points
    that have two patches or more."""
    n_points = len(_phototour_points(ids)[2])
    return torch.randint(0, n_points, (batch_size,), generator=generator).numpy()


def phototour_batch(patches: np.ndarray, ids: np.ndarray, sel: np.ndarray, size: int = 32):
    """Matched (anchor, positive) pairs [B, size, size] x2 (numpy) for the
    picks ``sel``: the first two patches of each picked 3D point,
    centre-cropped 64 -> size (TripletPhotoTour semantics)."""
    order, starts, pts = _phototour_points(ids)
    lo = (64 - size) // 2
    a_idx = order[starts[pts[sel]]]
    p_idx = order[starts[pts[sel]] + 1]
    return (patches[a_idx][:, lo:lo + size, lo:lo + size],
            patches[p_idx][:, lo:lo + size, lo:lo + size])


# --------------------------------------------------------------------------- #
# Drivers
# --------------------------------------------------------------------------- #
def train_asdnet(seed: int, n_steps: int = 200, batch_size: int = 256,
                 adaptive_until: int = None, base_lr: float = 0.5, device="cuda"):
    """Small-scale training driver on synthetic pairs: the init seeds from
    a CPU generator seeded with ``seed``, the batches and the steps' draws
    from one on ``device`` seeded with ``seed + 1``.  Returns the trained
    ``ASDNetTrain``.

    The reference's lr = 10 is tuned for batch 1024 on PhotoTour; the
    synthetic source is stable at a smaller one."""
    seeds = asdnet.draw_init_seeds(torch.Generator().manual_seed(seed))
    model = asdnet.ASDNetTrain(asdnet.init_params(seeds)).to(device)
    generator = torch.Generator(device).manual_seed(seed + 1)
    lrs = lr_table(n_steps, base_lr, device)
    adaptive_until = adaptive_until if adaptive_until is not None else n_steps // 2
    for step in range(n_steps):
        a, p = make_batch(draw_batch(generator, batch_size))
        train_step(model, a.to(device), p.to(device), lrs[step],
                   draw_step(generator, batch_size), adaptive=step < adaptive_until)
    return model


def evaluate_fpr95(model: asdnet.ASDNetTrain, generator: torch.Generator, n_pairs: int = 512):
    """FPR@95 of ``model``'s inference form (bf16, running statistics) on
    ``n_pairs`` fresh pairs from ``generator``, the positives rolled by one
    as negatives."""
    device = model.conv[0].device
    net = asdnet.ASDNet().to(device)
    net.load_state_dict(model.inference_state())
    a, p = make_batch(draw_batch(generator, n_pairs))
    with torch.no_grad():
        da, dp = net(a.to(device)), net(p.to(device))
    pos = torch.linalg.norm(da - dp, dim=1)
    neg = torch.linalg.norm(da - torch.roll(dp, 1, dims=0), dim=1)
    return fpr95(pos.cpu().numpy(), neg.cpu().numpy())
