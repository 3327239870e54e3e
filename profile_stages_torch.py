#!/usr/bin/env python3
"""Per-stage timing of the port's front end on the card.

The twin of profile_stages.py over asdslam_torch, with its stages on a
random image at the config's shape: the 8-level pyramid, FAST on level 0,
detection and patches over all levels (no descriptor), ASDNet on those
patches, the full extractor, the window match of a frame's features
against themselves, and the host-to-device copy of one image.  Each stage
is timed over 10 calls after a warm-up call, by CUDA events on the card
(the host clock off it).  Prints one line a stage, then one JSON line
``{"metric": "stage_ms", ...}`` with the card's name and power limit.

    python profile_stages_torch.py       # on the card
"""

import argparse
import json

CALLS = 10


def measure(cfg, device, calls=CALLS):
    """{stage: ms} of the seven stages on ``device``, in order."""
    import torch
    from asdslam_torch.frontend import extractor as extractor_mod
    from asdslam_torch.models import asdnet
    from asdslam_torch.ops import fast, match, pyramid
    from asdslam_torch.ops import patches as patches_mod
    from asdslam_torch.utils.roofline import time_ms

    device = torch.device(device)
    img = torch.rand(cfg.image_height, cfg.image_width,
                     generator=torch.Generator().manual_seed(0)).to(device)
    stages = {}

    def stage(name, fn):
        out = fn()
        ms = stages[name] = time_ms(fn, device, calls, windows=1)
        print(f"{name:30s} {ms:8.3f} ms", flush=True)
        return out

    levels = stage(f"pyramid({cfg.n_levels})",
                   lambda: pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor))
    stage("fast level0", lambda: fast.detect_level(levels[0], 20 / 255.0, 7 / 255.0, 500,
                                                  cfg.cell_size, 4, cfg.edge_margin))
    budgets = extractor_mod.level_budgets(cfg)

    def detect_all():
        outs = []
        for li, lv in enumerate(pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)):
            xy, _, _ = fast.detect_level(lv, 20 / 255.0, 7 / 255.0, budgets[li], cfg.cell_size,
                                         4, cfg.edge_margin)
            ang = patches_mod.ic_angle(lv, xy, radius=cfg.orientation_radius)
            blurred = pyramid.gaussian_blur(lv)
            outs.append(patches_mod.extract_rotated_patches(blurred, xy, torch.zeros_like(ang),
                                                            size=cfg.patch_size))
        return torch.cat(outs, 0)

    pat = stage("detect+patches(all lvls)", detect_all)
    net = asdnet.ASDNet().to(device)        # random weights from seed 0
    stage(f"asdnet({pat.shape[0]})", lambda: net(pat))
    extract = extractor_mod.make_extractor(cfg, net)
    feats = stage("full extract", lambda: extract(img))
    stage("match window", lambda: match.search_window(
        feats.desc, feats.desc, feats.uv_und, feats.uv_und, feats.valid, feats.valid,
        radius=100.0, max_dist=1.0, ratio=0.9, angles_a=feats.angle, angles_b=feats.angle,
        check_rotation=True))
    host = img.cpu().numpy()

    def upload():
        out = torch.from_numpy(host).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    stage("h2d image", upload)
    return stages


def main(argv=None, cfg=None, calls=CALLS):
    """``cfg`` (default ``SlamConfig()``, the KITTI shape) and ``calls`` are
    for the tests."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.system import device_names, require_device

    device = require_device(args.device)
    name, card = device_names(device)
    print(f"card: {card or 'none (the CPU)'}", flush=True)
    with torch.no_grad():
        stages = measure(cfg or SlamConfig(), device, calls)
    out = {"metric": "stage_ms", "device": name, "card": card, "stages": stages}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
