#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: the per-frame hot path on one card.

The twin of bench.py over asdslam_torch.  Primary metric: the fused tracking
step (frontend/track_step.py: extraction, the motion-model projection
search, pose-only BA, the local-map projection search against an 8192-row
candidate block, a second pose-only BA) at the reference workload shape
(1241x376, 2000 features, 8 pyramid levels, the trained ASDNet), frames
chained as the tracker chains them: frame i+1 consumes frame i's features,
pose, velocity and geometry block.  The host streams the frames and
synchronises once at the end of a 60-frame window; the value is the median
of three windows.

Extra fields: ``frontend_fps`` (extraction + the frame-to-frame window
match) and ``local_ba_ms`` (one local BA at the reference window:
local_ba_max_kfs + local_ba_max_fixed cameras, 4096 points, 16384
observations, 15 LM iterations; the keyframe-rate mapping cost).  The state
blocks are representative, not tracked: random geometry in front of the
camera and random candidate descriptors, from fixed seeds.

Baseline: 30 frames/s = 3x a nominal 10 frames/s CPU reference (the
reference publishes no frame rate; the anchor is a declared fiction for
trend tracking).  Prints one JSON line, with the device's name and, on a
card, its name and power limit as nvidia-smi reports them.

    python bench_torch.py                # on the card
"""

import argparse
import json
import os
import time

import numpy as np

from asdslam_torch.system import device_names, require_device

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_FPS = 30.0  # declared anchor: 3x a nominal 10 frames/s CPU (see docstring)


def median_window_fps(fn, sync, n_timed=60, reps=3):
    """Median over ``reps`` windows of ``n_timed`` chained calls of ``fn``,
    each window ending in one ``sync()``."""
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(n_timed)
        sync()
        samples.append(n_timed / (time.perf_counter() - t0))
    return float(np.median(samples))


def measure(cfg, asdnet_params, device, n_timed=60, reps=3, ba_points=4096, ba_obs=16384):
    """bench.py's three measurements of ``cfg`` on ``device``: the chained
    fused step's frames/s, frontend_fps and local_ba_ms."""
    import torch
    from asdslam_torch.backend import ba
    from asdslam_torch.frontend import extractor as extractor_mod
    from asdslam_torch.frontend import track_step as track_step_mod
    from asdslam_torch.io import synthetic
    from asdslam_torch.models import asdnet
    from asdslam_torch.ops import match

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    net = asdnet.ASDNet()
    if asdnet_params is not None:
        net.load_state_dict(asdnet_params)
    extract = extractor_mod.make_extractor(cfg, net.to(device))

    # frames rendered once, kept on the host as uint8: the timed loop
    # uploads each, as a data loader would
    frames, _ = synthetic.render_sequence(K, 8, cfg.image_height, cfg.image_width, step=0.3,
                                          device=device)
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).cpu() for f in frames]

    # ---- 1. the fused tracking step (primary) ------------------------------ #
    fused = track_step_mod.make_track_step(cfg, K, extract, device=device)
    N, P = cfg.n_features, cfg.local_ba_max_points
    gen = torch.Generator().manual_seed(7)

    def uniform(*shape, lo=-10.0, hi=10.0):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).to(device)

    ahead = torch.tensor([0.0, 0.0, 15.0], device=device)
    facing = torch.tensor([0.0, 0.0, -1.0], device=device)
    prev_feat = extract(frames_u8[0].to(device).to(torch.float32) / 255.0)
    prev_geom = track_step_mod.GeomBlock(
        pos=uniform(N, 3) + ahead, normal=facing.expand(N, 3).contiguous(),
        min_dist=torch.full((N,), 2.0, device=device),
        max_dist=torch.full((N,), 80.0, device=device),
        valid=torch.ones(N, dtype=torch.bool, device=device))
    cand = track_step_mod.PointBlock(
        pos=uniform(P, 3) + ahead, normal=facing.expand(P, 3).contiguous(),
        min_dist=torch.full((P,), 2.0, device=device),
        max_dist=torch.full((P,), 80.0, device=device),
        desc=(torch.randn(P, cfg.descriptor_dim, generator=gen) * 0.1).to(device),
        valid=torch.ones(P, dtype=torch.bool, device=device))
    state = dict(feat=prev_feat, geom=prev_geom,
                 pose=torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=device),
                 vel=torch.tensor([1.0, 0, 0, 0, 0, 0, 0.3], device=device),
                 crow=torch.full((N,), -1, dtype=torch.int32, device=device))

    def run_fused(n):
        feat, geom, pose, vel, crow = (state[k] for k in ("feat", "geom", "pose", "vel", "crow"))
        for i in range(n):
            feat, res = fused(frames_u8[i % 8], pose, vel, feat, geom, cand, crow)
            geom, pose, vel, crow = res.next_geom, res.pose, res.velocity, res.crow
        state.update(feat=feat, geom=geom, pose=pose, vel=vel, crow=crow)

    run_fused(2)  # warm-up
    sync()
    fused_fps = median_window_fps(run_fused, sync, n_timed, reps)

    # ---- 2. extraction + window match ------------------------------------- #
    def frame_step(img_u8, prev):
        f = extract(img_u8.to(device).to(torch.float32) * (1.0 / 255.0))
        _, _, ok = match.search_window(
            prev.desc, f.desc, prev.uv_und, f.uv_und, prev.valid, f.valid,
            radius=100.0, max_dist=1.0, ratio=0.9,
            angles_a=prev.angle, angles_b=f.angle, check_rotation=True)
        return f, ok.sum()

    fs = {"prev": prev_feat}

    def run_frontend(n):
        prev = fs["prev"]
        for i in range(n):
            prev, _ = frame_step(frames_u8[i % 8], prev)
        fs["prev"] = prev

    run_frontend(2)
    sync()
    frontend_fps = median_window_fps(run_frontend, sync, n_timed, reps)

    # ---- 3. local BA at the reference window (keyframe-rate mapping) ------- #
    C = cfg.local_ba_max_kfs + cfg.local_ba_max_fixed
    gen = torch.Generator().manual_seed(9)
    pts = torch.rand(ba_points, 3, generator=gen) * 10.0 - 5.0 + torch.tensor([0.0, 0.0, 10.0])
    poses7 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0]).repeat(C, 1)
    poses7[:, 6] = torch.arange(C) * 0.1
    cam_idx = torch.randint(0, C, (ba_obs,), generator=gen)
    pt_idx = torch.randint(0, ba_points, (ba_obs,), generator=gen)
    uv = torch.stack([K[0, 0] * pts[pt_idx, 0] / pts[pt_idx, 2] + K[0, 2],
                      K[1, 1] * pts[pt_idx, 1] / pts[pt_idx, 2] + K[1, 2]], 1)
    obs = ba.Obs(cam_idx=cam_idx.to(device), pt_idx=pt_idx.to(device), uv=uv.to(device),
                 inv_sigma2=torch.ones(ba_obs, device=device),
                 valid=torch.ones(ba_obs, dtype=torch.bool, device=device))
    pt_obs = ba.build_pt_obs(pt_idx.numpy(), np.ones(ba_obs, bool), ba_points, 16)
    prob = ba.BAProblem(poses7=poses7.to(device), points=pts.to(device),
                        pt_valid=torch.ones(ba_points, dtype=torch.bool, device=device),
                        obs=obs, pt_obs=torch.as_tensor(pt_obs).to(device))
    Kd = K.to(device)
    ba.bundle_adjust(prob, Kd, n_opt=cfg.local_ba_max_kfs, iters=15)
    sync()
    tb = []
    for _ in range(3):
        t0 = time.perf_counter()
        ba.bundle_adjust(prob, Kd, n_opt=cfg.local_ba_max_kfs, iters=15)
        sync()
        tb.append((time.perf_counter() - t0) * 1000.0)
    return {
        "metric": "fused_track_fps_kitti_shape",
        "value": round(fused_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fused_fps / BASELINE_FPS, 3),
        "frontend_fps": round(frontend_fps, 2),
        "local_ba_ms": round(float(np.median(tb)), 1),
        "use_pallas_match": cfg.use_pallas_match,
        "baseline_note": "30fps = 3x nominal 10fps CPU; reference publishes no fps",
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from asdslam_torch.config import SlamConfig
    from asdslam_torch.models import asdnet

    device = require_device(args.device)
    weights = os.path.join(ROOT, "asdnet_weights.pkl")
    params = asdnet.load_weights(weights) if os.path.exists(weights) else None
    out = measure(SlamConfig(), params, device)  # KITTI defaults: 1241x376, 2000 features
    out["device"], out["card"] = device_names(device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
