#!/usr/bin/env python3
"""ATE evaluation of the PyTorch/CUDA port on the KITTI proxy: full-resolution
textured renders along a KITTI ground-truth trajectory
(asdslam_torch/io/kitti_proxy.py), tracked end to end and scored with the
reference's protocol (sim3 Umeyama alignment over all frames, ATE RMSE).

The twin of eval_kitti_proxy.py over asdslam_torch: the same flags (plus
``--device``; the run is on the card unless ``--device cpu``), the same
``render`` span and the same JSON keys: the sim3 and se3 ATE of the live
frame trajectory, the sim3 ATE of the keyframes and of the recomposed frame
trajectory, both drift analyses, the loop funnel and the accepted loops.
``--no_pallas`` has no twin: on the card the port's matcher is the
hand-written kernel, and its plain version runs only for CPU tensors.

The ground truth and camera files are read from the repository's
``reference/`` (kitti_proxy.GT_DIR / CAM_DIR); without them the script
exits with the missing file's path.

Usage:
  python eval_kitti_proxy_torch.py --seq 03 --out ATE_seq03.json
  python eval_kitti_proxy_torch.py --seq 03 --scale 0.5 --max_frames 200  # quick
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        description="KITTI-proxy ATE of the port.  eval_kitti_proxy.py's --no_pallas has no "
                    "twin: on the card the matcher is the hand-written kernel, and its plain "
                    "version runs only for CPU tensors (--device cpu).")
    p.add_argument("--seq", default="03")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--n_boxes", type=int, default=256)
    p.add_argument("--descriptor", choices=["asd", "patch", "orb"], default="patch")
    p.add_argument("--asdnet_weights", default="")
    p.add_argument("--no_loop_closing", action="store_true")
    p.add_argument("--voc_addr", default="",
                   help="offline vocabulary .npz (train_vocab_torch.py): skips the online "
                        "k-means training, as the reference's --voc_addr")
    p.add_argument("--save_voc", default="",
                   help="save the (online-trained) vocabulary here at the end")
    p.add_argument("--out", default="")
    p.add_argument("--traj_out", default="")
    p.add_argument("--profile", action="store_true",
                   help="print the per-stage tracer report at the end")
    p.add_argument("--viz_dir", default="",
                   help="publish visualization topics (asdslam_torch/viz.py)")
    p.add_argument("--viz_every", type=int, default=200)
    p.add_argument("--local_ba_kfs", type=int, default=0,
                   help="override local-BA window caps (A/B experiments)")
    p.add_argument("--f32_desc", action="store_true",
                   help="upload descriptors f32 instead of bf16 (A/B)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch
    from asdslam_torch import viz
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.io import kitti_proxy
    from asdslam_torch.loop import vocab as vocab_mod
    from asdslam_torch.mapping.map_store import _pose_np
    from asdslam_torch.models import asdnet, patch_descriptor
    from asdslam_torch.system import System, require_device
    from asdslam_torch.utils import evaluate

    device = require_device(args.device)
    for path in (kitti_proxy.gt_path(args.seq), kitti_proxy.camera_config_path(args.seq)):
        if not os.path.exists(path):
            sys.exit(f"eval_kitti_proxy_torch.py: {path} not found (the KITTI ground truth and "
                     "camera files of the reference repository, under this repository's "
                     "reference/)")
    seq = kitti_proxy.KittiProxySequence(args.seq, scale=args.scale, n_boxes=args.n_boxes,
                                         max_frames=args.max_frames or None, device=device)
    base = SlamConfig()
    if args.scale < 1.0:
        base = base.replace(n_features=max(600, int(2000 * args.scale)),
                            n_levels=4 if args.scale <= 0.5 else 8,
                            local_ba_max_points=4096, local_ba_max_obs=16384)
    cfg = seq.config(base)
    if args.local_ba_kfs:
        cfg = cfg.replace(local_ba_max_kfs=args.local_ba_kfs,
                          local_ba_max_fixed=args.local_ba_kfs)
    if args.f32_desc:
        cfg = cfg.replace(desc_upload_bf16=False)

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
        sys.exit(f"eval_kitti_proxy_torch.py: {e}")
    if args.voc_addr and system.loop_closer is not None:
        system.loop_closer.vocab = vocab_mod.load_vocab(args.voc_addr, device=device)

    viz.VisualizationSink.reset()
    if args.viz_dir:
        viz.VisualizationSink.init(args.viz_dir)

    n = len(seq)
    viz_traj = []
    t0 = time.time()
    for i in range(n):
        with system.tracer.span("render"):
            ts, img = seq[i]
            # the render is queued on the device: wait for it here, so that
            # its time is the render span's and not the tracking window's
            if img.is_cuda:
                torch.cuda.synchronize(img.device)
        pose = system.track_monocular(img, i)
        if args.viz_dir and pose is not None:
            R, t = _pose_np(np.asarray(pose))
            viz_traj.append(-R.T @ t)
        if args.viz_dir and i and i % args.viz_every == 0:
            viz.publish_map_snapshot(system.store)
            viz.VisualizationSink.publish_image(
                "map/topdown", viz.render_topdown(system.store, trajectory=viz_traj))
        if i % 100 == 0:
            s = system.stats()
            print(f"frame {i}/{n} kfs={s['n_keyframes']} mps={s['n_map_points']} "
                  f"state={s['state']} {(i + 1) / (time.time() - t0):.1f} fps", flush=True)
    wall = time.time() - t0
    # rendering (the proxy world's synthesis, not part of the SLAM system)
    # apart from tracking: fps_tracking is the system's own rate, fps the
    # loop's wall clock with the renders
    render_s = system.tracer.spans.get("render")
    render_s = render_s.total if render_s else 0.0

    est = evaluate.camera_centers(system.frame_trajectory())
    gt = evaluate.camera_centers([(i, seq.gt_pose7[i]) for i in range(n)])
    e, g = evaluate.associate_by_id(est, gt)
    result = {
        "seq": args.seq, "scale": args.scale, "frames": n,
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
        result["loop_events"] = [{"kf": k, "cand": c, "frame": fr}
                                 for (k, c, fr) in system.loop_closer.accepted_log]
    if len(e) >= 10:
        result["ate_sim3_m"] = round(float(evaluate.ate_rmse(e, g, align="sim3")), 3)
        result["ate_se3_m"] = round(float(evaluate.ate_rmse(e, g, align="se3")), 3)
        ids = sorted(set(est) & set(gt))
        result["drift"] = evaluate.drift_analysis(e, g, ids=ids)
    # the reference protocol: the ATE of the final keyframe trajectory (every
    # optimisation applied; System::SaveKeyFrameTrajectoryTUM).  The live
    # frame trajectory above is the stricter number: poses as tracked,
    # before a later loop correction could rewrite them.
    est_kf = evaluate.camera_centers(system.keyframe_trajectory())
    ekf, gkf = evaluate.associate_by_id(est_kf, gt)
    result["keyframe_poses"] = len(ekf)
    if len(ekf) >= 10:
        result["ate_kf_sim3_m"] = round(float(evaluate.ate_rmse(ekf, gkf, align="sim3")), 3)
    # the reference protocol's frame trajectory: per-frame relative poses
    # recomposed through the final keyframe poses (SaveTrajectoryTUM)
    est_rc = evaluate.camera_centers(system.frame_trajectory_recomposed())
    erc, grc = evaluate.associate_by_id(est_rc, gt)
    if len(erc) >= 10:
        result["ate_frame_recomposed_m"] = round(
            float(evaluate.ate_rmse(erc, grc, align="sim3")), 3)
        result["frames_recomposed"] = len(erc)
        kf_ids = sorted(set(est_kf) & set(gt))
        result["drift_kf"] = evaluate.drift_analysis(ekf, gkf, ids=kf_ids)
    if args.profile:
        print(system.tracer.report(), flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "drift"}))
    if args.traj_out:
        system.save_trajectory_tum(args.traj_out, {i: seq.timestamps[i] for i in range(n)})
    if args.save_voc and system.loop_closer is not None \
            and system.loop_closer.vocab is not None:
        vocab_mod.save_vocab(system.loop_closer.vocab, args.save_voc)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return system, result


if __name__ == "__main__":
    main()
