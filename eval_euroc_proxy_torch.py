#!/usr/bin/env python3
"""ATE evaluation of the PyTorch/CUDA port on the EuRoC-analog proxy:
aggressive 6-DoF MAV motion at 752x480 through the real EuRoC cam0 radtan
intrinsics, distortion active end to end, frames rendered on the device.

The twin of eval_euroc_proxy.py over asdslam_torch: the same flags (plus
``--device``; the run is on the card unless ``--device cpu``), the same
``render`` span and the same JSON keys: sim3 Umeyama ATE RMSE of the live
frame trajectory, of the keyframes and of the recomposed frame trajectory,
the drift analysis, the loop funnel and the accepted loops.

Usage:
  python eval_euroc_proxy_torch.py --out euroc.json
  python eval_euroc_proxy_torch.py --frames 200 --scale 0.5   # quick
"""

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=1300)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--descriptor", choices=["asd", "patch", "orb"], default="patch")
    p.add_argument("--asdnet_weights", default="")
    p.add_argument("--no_loop_closing", action="store_true")
    p.add_argument("--voc_addr", default="", help="offline vocabulary .npz (train_vocab_torch.py)")
    p.add_argument("--out", default="")
    p.add_argument("--traj_out", default="")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from asdslam_torch.config import SlamConfig
    from asdslam_torch.io.euroc_proxy import EurocProxySequence
    from asdslam_torch.loop import vocab as vocab_mod
    from asdslam_torch.models import asdnet, patch_descriptor
    from asdslam_torch.system import System, require_device
    from asdslam_torch.utils import evaluate

    device = require_device(args.device)
    seq = EurocProxySequence(n_frames=args.frames, scale=args.scale, device=device)
    base = SlamConfig()
    if args.scale < 1.0:
        base = base.replace(n_features=max(600, int(2000 * args.scale)),
                            n_levels=4 if args.scale <= 0.5 else 8,
                            local_ba_max_points=4096, local_ba_max_obs=16384)
    cfg = seq.config(base)
    if not cfg.has_distortion:
        raise AssertionError("the EuRoC proxy's camera has no distortion")

    descriptor_fn = None
    asdnet_params = None
    if args.descriptor == "patch":
        descriptor_fn = patch_descriptor.apply
    elif args.descriptor == "orb":
        cfg = cfg.replace(use_orb=True)
    elif args.asdnet_weights:
        asdnet_params = asdnet.load_weights(args.asdnet_weights)

    try:
        system = System(cfg, asdnet_params=asdnet_params, descriptor_fn=descriptor_fn,
                        do_loop_closing=not args.no_loop_closing, device=device)
    except NotImplementedError as e:
        sys.exit(f"eval_euroc_proxy_torch.py: {e}")
    if args.voc_addr and system.loop_closer is not None:
        system.loop_closer.vocab = vocab_mod.load_vocab(args.voc_addr, device=device)

    n = len(seq)
    t0 = time.time()
    for i in range(n):
        with system.tracer.span("render"):
            ts, img = seq[i]
        system.track_monocular(img, i)
        if i % 100 == 0:
            s = system.stats()
            print(f"frame {i}/{n} kfs={s['n_keyframes']} mps={s['n_map_points']} "
                  f"state={s['state']} {(i + 1) / (time.time() - t0):.1f} fps", flush=True)
    wall = time.time() - t0
    render_s = system.tracer.spans.get("render")
    render_s = render_s.total if render_s else 0.0

    est = evaluate.camera_centers(system.frame_trajectory())
    gt = evaluate.camera_centers([(i, seq.gt_pose7[i]) for i in range(n)])
    e, g = evaluate.associate_by_id(est, gt)
    result = {
        "dataset": "euroc_proxy", "frames": n, "scale": args.scale,
        "resolution": [seq.width, seq.height],
        "distortion": list(seq.dist),
        "tracked": len(system.frame_trajectory()),
        "matched_gt": len(e),
        "keyframes": system.stats()["n_keyframes"],
        "map_points": system.stats()["n_map_points"],
        "loops_closed": system.loop_closer.n_loops_closed if system.loop_closer else 0,
        "fps": round(n / wall, 2),
        "fps_tracking": round(n / max(wall - render_s, 1e-9), 2),
        "descriptor": args.descriptor,
        "path_length_m": round(float(np.linalg.norm(
            np.diff(seq.centers, axis=0), axis=1).sum()), 1),
    }
    if system.loop_closer is not None:
        result["loop_funnel"] = system.loop_closer.counters
    if len(e) >= 10:
        result["ate_sim3_m"] = round(float(evaluate.ate_rmse(e, g, align="sim3")), 3)
        ids = sorted(set(est) & set(gt))
        result["drift"] = evaluate.drift_analysis(e, g, ids=ids)
    est_kf = evaluate.camera_centers(system.keyframe_trajectory())
    ekf, gkf = evaluate.associate_by_id(est_kf, gt)
    result["keyframe_poses"] = len(ekf)
    if len(ekf) >= 10:
        result["ate_kf_sim3_m"] = round(float(evaluate.ate_rmse(ekf, gkf, align="sim3")), 3)
    # the reference protocol's frame trajectory: per-frame relative poses
    # recomposed through the final keyframe poses (SaveTrajectoryTUM), so
    # loop and global-BA corrections repair the whole frame trajectory
    est_rc = evaluate.camera_centers(system.frame_trajectory_recomposed())
    erc, grc = evaluate.associate_by_id(est_rc, gt)
    if len(erc) >= 10:
        result["ate_frame_recomposed_m"] = round(
            float(evaluate.ate_rmse(erc, grc, align="sim3")), 3)
        result["frames_recomposed"] = len(erc)
    if system.loop_closer is not None:
        result["loop_events"] = [{"kf": k, "cand": c, "frame": fr}
                                 for (k, c, fr) in system.loop_closer.accepted_log]
    if args.profile:
        print(system.tracer.report(), flush=True)
    print(json.dumps(result))
    if args.traj_out:
        system.save_trajectory_tum(args.traj_out, {i: seq.timestamps[i] for i in range(n)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return system, result


if __name__ == "__main__":
    main()
