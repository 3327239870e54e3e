#!/usr/bin/env python3
"""MFU / roofline accounting of the port's hot functions on the card.

The twin of mfu_bench.py over asdslam_torch, with the same five rows built
from the same inputs (torch generators seeded from the JAX script's
integers): the projection matcher at 2000x2000 and 8192x2000, the ASDNet
forward on 2000 patches, one local BA at the reference window (15 LM
iterations) and the fused tracking step.  For each: the FLOPs and the bytes
the work needs, counted from its shapes (the matcher's from its data)
whatever implements it, its time
(the median of 5 windows of 10 chained calls, one synchronisation a window,
timed by CUDA events), then

  mfu       = flops / time / the compute peak the row names
  bw_util   = bytes / time / the memory peak
  sol_frac  = the least time (the larger of flops / compute peak and
              bytes / memory peak) over the time: the share of the speed
              of light reached; ``bound`` says which of the two sets it.

The counts are the JAX script's, with two exceptions, both in the
matcher's work, which the roofline module counts once for this script and
for chip_smoke.py's kernel bound:

- the matcher's bytes are its inputs read once and its outputs written once
  (``roofline.matcher_bytes``), in its row and in the fused step's.  The
  JAX script's 4·N·M·4 and 2·(N·N + P·N)·4·3 terms count the distance
  matrices its jnp matcher writes and reads back; the function does not
  need them, and the port's kernel (K1, csrc/masked_nn.cu) never writes
  them;
- the matcher row's FLOPs are the dot products of the pairs that pass the
  gates on the row's data (``roofline.matcher_flops``; ``pairs_in`` in the
  row), not the JAX script's 2·N·M·d over every pair: with a 15 px window
  over a 1200 px square about 0.05% of the pairs pass.  The fused step's
  two searches keep the JAX script's 2·N·N·d + 2·P·N·d (a dense-equivalent
  count, 5.2 of the step's 161.7 GFLOP at the KITTI shape): their data is
  the step's own, and the row is the share of the whole step.

The peaks come from one definition (``asdslam_torch/utils/roofline.py``),
keyed by the card's name: another card raises.  The matcher, ASDNet and the
step are held to the bf16 peak, local BA (float32) to the float32 peak.  A
share above 1.05 raises: a count or a timing is wrong.  The fused step's
row is the share of the whole step.

Prints the card's name and power limit (nvidia-smi), then one JSON line
``{"metric": "mfu_roofline", ...}``.  ``--device cpu`` (for the tests)
gives the rows' ms, gflops and mbytes, with null shares.

    python mfu_bench_torch.py            # on the card
"""

import argparse
import json

import numpy as np

MATCH_SHAPES = (("match_motion_2000x2000", 2000, 2000), ("match_localmap_8192x2000", 8192, 2000))
BA_SHAPE = (4096, 16384)     # points, observations of the local-BA row
BA_ITERS = 15
CALLS, WINDOWS = 10, 5


def asdnet_flops(n_patches):
    """Conv tower FLOPs (models/asdnet.py's layer table, ASDNet.py:331-370):
    2 * H * W * Cin * Cout * k^2 per conv."""
    layers = [  # (H, W, Cin, Cout, k)
        (32, 32, 1, 32, 3), (32, 32, 32, 32, 3),
        (16, 16, 32, 64, 3), (16, 16, 64, 64, 3),
        (8, 8, 64, 128, 3), (8, 8, 128, 128, 3),
        (1, 1, 128, 128, 8),
    ]
    per = sum(2 * h * w * ci * co * k * k for h, w, ci, co, k in layers)
    return per * n_patches


def asdnet_bytes(n_patches):
    """Activations in and out of every layer, in bf16 (the JAX script's count)."""
    act = n_patches * (32 * 32 * (1 + 32 + 32) + 16 * 16 * (64 + 64)
                       + 8 * 8 * (128 + 128) + 128)
    return act * 2


def local_ba_work(n_opt_cams, n_points, n_obs, iters=BA_ITERS):
    """(FLOPs, bytes) of ``iters`` LM iterations (the JAX script's count): per
    iteration ~2000 FLOP an observation for the residuals, Jacobians and
    their outer products, ~150 a point for its 3x3 solve, ~40 an
    (observation, optimised camera coordinate) for the reduced system, and
    the dense solve; the bytes the per-observation and per-point blocks."""
    no = n_opt_cams * 6
    flops = iters * (n_obs * 2000 + n_points * 150 + n_obs * no * 40 + no ** 3 // 3)
    bytes_ = iters * (n_obs * (2 + 12 + 6 + 18) * 4 * 3 + n_points * 9 * 4 * 2)
    return flops, bytes_


def fused_step_work(cfg):
    """(FLOPs, bytes) of one fused tracking step: the JAX script's FLOPs
    (ASDNet, both searches' products over every pair, 8 pose-optimisation
    rounds) and its bytes of the pyramid's passes over the image, with the
    two searches' bytes as ``roofline.matcher_bytes`` counts them in place
    of its distance blocks."""
    from asdslam_torch.utils.roofline import matcher_bytes

    N, P, d = cfg.n_features, cfg.local_ba_max_points, 128
    flops = asdnet_flops(N) + 2 * N * N * d + 2 * P * N * d + 8 * 10 * N * 600
    img_b = cfg.image_height * cfg.image_width * 4 * 10
    return flops, img_b + matcher_bytes(N, N, d) + matcher_bytes(P, N, d)


def measure(cfg, device, peaks, match_shapes=MATCH_SHAPES, ba_shape=BA_SHAPE,
            calls=CALLS, windows=WINDOWS):
    """The five rows on ``device`` (roofline.roofline_row, against ``peaks``
    or, for None, with null shares)."""
    import torch
    from asdslam_torch.backend import ba
    from asdslam_torch.frontend import extractor as extractor_mod
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.models import asdnet
    from asdslam_torch.ops import masked_nn, match
    from asdslam_torch.utils.roofline import (matcher_bytes, matcher_flops, roofline_row,
                                              time_ms)

    device = torch.device(device)
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]], device=device)
    rows = []

    def timed(fn):
        return time_ms(fn, device, calls, windows)

    # ---- 1. the projection matcher (K1 on the card) -------------------- #
    for label, N, M in match_shapes:
        g = torch.Generator().manual_seed(0)
        a, b = torch.randn(N, 128, generator=g), torch.randn(M, 128, generator=g)
        uv_a = torch.rand(N, 2, generator=g) * 1200.0
        uv_b = torch.rand(M, 2, generator=g) * 1200.0
        a, b, uv_a, uv_b = (x.to(device) for x in (a, b, uv_a, uv_b))
        va = torch.ones(N, dtype=torch.bool, device=device)
        vb = torch.ones(M, dtype=torch.bool, device=device)
        radius = torch.full((N,), 15.0, device=device)
        ms = timed(lambda: match.search_projection(a, b, uv_a, uv_b, va, vb, radius, 1.5,
                                                   ratio=0.8))
        gate = masked_nn.gate_plain(va, vb, uv_a, uv_b, radius * radius,
                                    *masked_nn._defaults(a, b, uv_a, uv_b, None, None, None)[3:])
        pairs_in = int(gate.sum())
        rows.append(dict(roofline_row(label, ms, matcher_flops(pairs_in, 128),
                                      matcher_bytes(N, M, 128), peaks, "bf16"),
                         pairs_in=pairs_in))

    # ---- 2. the ASDNet forward (bf16 convs) ----------------------------- #
    n_p = cfg.n_features
    net = asdnet.ASDNet().to(device)        # random weights from seed 0
    patches = torch.rand(n_p, 32, 32, generator=torch.Generator().manual_seed(1)).to(device)
    with torch.no_grad():
        ms = timed(lambda: net(patches))
    rows.append(roofline_row(f"asdnet_forward_{n_p}x32x32", ms, asdnet_flops(n_p),
                             asdnet_bytes(n_p), peaks, "bf16"))

    # ---- 3. local BA at the reference window (float32) ------------------ #
    C = cfg.local_ba_max_kfs + cfg.local_ba_max_fixed
    Pt, O = ba_shape
    g = torch.Generator().manual_seed(9)
    pts = torch.rand(Pt, 3, generator=g) * 10.0 - 5.0 + torch.tensor([0.0, 0.0, 10.0])
    cam_idx = torch.randint(0, C, (O,), generator=g)
    pt_idx = torch.randint(0, Pt, (O,), generator=g)
    Kc = K.cpu()
    uv = torch.stack([Kc[0, 0] * pts[pt_idx, 0] / pts[pt_idx, 2] + Kc[0, 2],
                      Kc[1, 1] * pts[pt_idx, 1] / pts[pt_idx, 2] + Kc[1, 2]], 1)
    obs = ba.Obs(cam_idx=cam_idx.to(device), pt_idx=pt_idx.to(device), uv=uv.to(device),
                 inv_sigma2=torch.ones(O, device=device),
                 valid=torch.ones(O, dtype=torch.bool, device=device))
    pt_obs = ba.build_pt_obs(pt_idx.numpy(), np.ones(O, bool), Pt, 16)
    prob = ba.BAProblem(
        poses7=torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=device).repeat(C, 1),
        points=pts.to(device), pt_valid=torch.ones(Pt, dtype=torch.bool, device=device),
        obs=obs, pt_obs=torch.as_tensor(pt_obs).to(device))
    ms = timed(lambda: ba.bundle_adjust(prob, K, n_opt=cfg.local_ba_max_kfs, iters=BA_ITERS))
    flops, bytes_ = local_ba_work(cfg.local_ba_max_kfs, Pt, O)
    rows.append(roofline_row(f"local_ba_{C}c_{Pt}p_{O}o_15it", ms, flops, bytes_, peaks, "f32"))

    # ---- 4. the fused tracking step (the whole step) -------------------- #
    extract = extractor_mod.make_extractor(cfg, net)
    fused = ts.make_track_step(cfg, K, extract, device=device)
    N, P = cfg.n_features, cfg.local_ba_max_points
    g = torch.Generator().manual_seed(7)
    ahead = torch.tensor([0.0, 0.0, 15.0])
    geom_pos = torch.rand(N, 3, generator=g) * 20.0 - 10.0 + ahead
    cand_pos = torch.rand(P, 3, generator=g) * 20.0 - 10.0 + ahead
    cand_desc = torch.randn(P, cfg.descriptor_dim, generator=g) * 0.1
    img = torch.rand(cfg.image_height, cfg.image_width, generator=g).to(device)
    facing = torch.tensor([0.0, 0.0, -1.0], device=device)

    def full(n, v):
        return torch.full((n,), v, device=device)

    geom = ts.GeomBlock(pos=geom_pos.to(device), normal=facing.expand(N, 3).contiguous(),
                        min_dist=full(N, 2.0), max_dist=full(N, 80.0),
                        valid=torch.ones(N, dtype=torch.bool, device=device))
    cand = ts.PointBlock(pos=cand_pos.to(device), normal=facing.expand(P, 3).contiguous(),
                         min_dist=full(P, 2.0), max_dist=full(P, 80.0),
                         desc=cand_desc.to(device),
                         valid=torch.ones(P, dtype=torch.bool, device=device))
    pose0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=device)
    vel0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0.3], device=device)
    with torch.no_grad():
        feat0 = extract(img)
        ms = timed(lambda: fused(img, pose0, vel0, feat0, geom, cand)[1].pose)
    flops, bytes_ = fused_step_work(cfg)
    rows.append(roofline_row("fused_track_step", ms, flops, bytes_, peaks, "bf16"))
    return rows


def main(argv=None, cfg=None, **sizes):
    """``cfg`` (default ``SlamConfig()``, the KITTI shape) and ``sizes``
    (``measure``'s shapes and window counts) are for the tests."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from asdslam_torch.config import SlamConfig
    from asdslam_torch.system import device_names, require_device
    from asdslam_torch.utils.roofline import peaks_for

    device = require_device(args.device)
    name, card = device_names(device)
    peaks = peaks_for(name) if device.type == "cuda" else None
    print(f"card: {card or 'none (the CPU: no shares)'}", flush=True)
    rows = measure(cfg or SlamConfig(), device, peaks, **sizes)
    out = {"metric": "mfu_roofline", "device": name, "card": card, "peaks": peaks,
           "kernels": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
