#!/usr/bin/env python3
"""Command-line entry point of the PyTorch/CUDA port: run monocular SLAM on a
KITTI or EuRoC sequence, the synthetic corridor or a KITTI proxy.

The twin of run_slam.py over asdslam_torch: the same flags and the same
output (progress lines, the keyframe trajectory, the final JSON line), plus
``--device``: the run is on the card ("cuda", the default) unless the caller
asks for the CPU, and without a card it exits with a message.

Examples:
  python run_slam_torch.py --dataset kitti --seq_dir /data/kitti/00 \
      --camera_config kitti00-02.txt --asdnet_weights asdnet_weights.pkl \
      --save_map run.map --output_addr traj.txt
  python run_slam_torch.py --dataset kitti --seq_dir ... --map_addr run.map \
      --localization           # track against a prior map
  python run_slam_torch.py --dataset synthetic --device cpu --n_frames 20
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["kitti", "euroc", "synthetic", "kitti_proxy"],
                   default="synthetic")
    p.add_argument("--proxy_seq", default="03",
                   help="kitti_proxy: which KITTI ground-truth trajectory")
    p.add_argument("--proxy_scale", type=float, default=1.0)
    p.add_argument("--seq_dir", default="")
    p.add_argument("--camera_config", default="")
    p.add_argument("--output_addr", default="traj_out.txt")
    p.add_argument("--map_addr", default="")
    p.add_argument("--save_map", default="")
    p.add_argument("--localization", action="store_true")
    p.add_argument("--use_orb", action="store_true")
    p.add_argument("--feature_count", type=int, default=2000)
    p.add_argument("--feature_scale_factor", type=float, default=1.2)
    p.add_argument("--feature_level", type=int, default=8)
    p.add_argument("--min_match_count", type=int, default=100)
    p.add_argument("--max_step_KF", type=int, default=15)
    p.add_argument("--min_frame", type=int, default=0)
    p.add_argument("--max_frame", type=int, default=1 << 30)
    p.add_argument("--step_frame", type=int, default=1)
    p.add_argument("--loop_closing", action="store_true", default=True)
    p.add_argument("--no_loop_closing", dest="loop_closing", action="store_false")
    p.add_argument("--asdnet_weights", default="")
    p.add_argument("--voc_addr", default="", help="vocabulary .npz to load (--voc_addr parity)")
    p.add_argument("--save_voc", default="",
                   help="save the (online-trained) vocabulary here at the end")
    p.add_argument("--save_result_dir", default="",
                   help="dump track/desc/kps/posi/traj.txt (saveResult parity)")
    p.add_argument("--n_frames", type=int, default=150, help="synthetic only")
    p.add_argument("--n_devices", type=int, default=1,
                   help="device-mesh size: >1 routes loop-closure global BA "
                        "through the point-major distributed solver "
                        "(parallel/dist.py)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall-time spans at the end")
    p.add_argument("--viz_dir", default="",
                   help="publish visualization topics here (trajectory/points/covisibility "
                        "PLY, top-down PNG, the frame; asdslam_torch/viz.py)")
    p.add_argument("--viz_every", type=int, default=50,
                   help="publish a map snapshot every N frames")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch
    from asdslam_torch import viz
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.io import datasets, synthetic
    from asdslam_torch.loop import vocab as vocab_mod
    from asdslam_torch.mapping.map_store import _pose_np
    from asdslam_torch.models import asdnet
    from asdslam_torch.system import System, require_device

    device = require_device(args.device)
    cfg = SlamConfig(
        n_features=args.feature_count,
        scale_factor=args.feature_scale_factor,
        n_levels=args.feature_level,
        min_match_count=args.min_match_count,
        max_step_kf=args.max_step_KF,
        use_orb=args.use_orb,
        n_devices=args.n_devices,
    )

    if args.dataset == "kitti_proxy":
        # textured proxy along a real KITTI ground-truth trajectory
        from asdslam_torch.io import kitti_proxy
        for path in (kitti_proxy.gt_path(args.proxy_seq),
                     kitti_proxy.camera_config_path(args.proxy_seq)):
            if not os.path.exists(path):
                sys.exit(f"kitti_proxy: {path} not found (the KITTI ground truth and "
                         "camera files of the reference repository, under this repository's "
                         "reference/)")
        seq = kitti_proxy.KittiProxySequence(args.proxy_seq, scale=args.proxy_scale,
                                             device=device)
        cfg = seq.config(cfg)
        h, w = cfg.image_height, cfg.image_width
    elif args.dataset == "kitti":
        seq = datasets.KittiSequence(args.seq_dir)
        ts0, img0 = seq[0]
        h, w = img0.shape
    elif args.dataset == "euroc":
        seq = datasets.EurocSequence(args.seq_dir)
        ts0, img0 = seq[0]
        h, w = img0.shape
    else:
        h, w = 240, 320
        cfg = cfg.replace(image_height=h, image_width=w,
                          fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                          n_features=min(args.feature_count, 800), n_levels=4)
        K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
        frames, poses = synthetic.render_sequence(
            K, n_frames=args.n_frames, height=h, width=w,
            step=0.22, turn=2 * np.pi / 110,
            scene=synthetic.Scene(left_x=-8.0, right_x=8.0, back_z=-8.0, front_z=16.0),
            device=device)
        frames = frames.cpu().numpy()
        seq = [(float(i), frames[i]) for i in range(args.n_frames)]

    if args.camera_config:
        info = datasets.read_cam_info(args.camera_config)
        cfg = datasets.config_from_cam_info(cfg, info, w, h)
    elif args.dataset not in ("synthetic", "kitti_proxy"):
        sys.exit("--camera_config required for kitti/euroc")

    asdnet_params = asdnet.load_weights(args.asdnet_weights) if args.asdnet_weights else None

    try:
        system = System(cfg, asdnet_params=asdnet_params,
                        do_loop_closing=args.loop_closing and not args.localization,
                        localization_mode=args.localization, device=device)
    except NotImplementedError as e:
        sys.exit(f"run_slam_torch.py: {e}")
    if args.voc_addr and system.loop_closer is not None:
        system.loop_closer.vocab = vocab_mod.load_vocab(args.voc_addr, device=device)
    if args.map_addr:
        system.load_map(args.map_addr)

    viz.VisualizationSink.reset()
    if args.viz_dir:
        viz.VisualizationSink.init(args.viz_dir)

    n = len(seq)
    t0 = time.time()
    tracked = 0
    timestamps = {}
    traj_centers = []
    for i in range(args.min_frame, min(n, args.max_frame), args.step_frame):
        ts, img = seq[i]
        timestamps[i] = ts
        pose = system.track_monocular(img, i)
        if pose is not None:
            tracked += 1
            R, t = _pose_np(np.asarray(pose))
            traj_centers.append(-R.T @ t)
        if args.viz_dir and i % args.viz_every == 0:
            viz.publish_map_snapshot(system.store)
            viz.VisualizationSink.publish_image(
                "map/topdown", viz.render_topdown(system.store, trajectory=traj_centers))
            viz.VisualizationSink.publish_image(
                "camera/frame", torch.as_tensor(img).cpu().numpy())
        if i % 50 == 0:
            s = system.stats()
            print(f"frame {i}/{n} tracked={tracked} kfs={s['n_keyframes']} "
                  f"mps={s['n_map_points']} "
                  f"{(i + 1 - args.min_frame) / (time.time() - t0):.1f} fps", flush=True)
    wall = time.time() - t0

    # the trajectory accessor drains the pipeline (the deferred frame and the
    # mapping worker) before anything below reads the store
    system.save_trajectory_tum(args.output_addr, timestamps)
    if args.save_map:
        system.save_map(args.save_map)
    if args.save_voc and system.loop_closer is not None \
            and system.loop_closer.vocab is not None:
        vocab_mod.save_vocab(system.loop_closer.vocab, args.save_voc)
    if args.save_result_dir:
        system.save_result(args.save_result_dir)
    if args.profile:
        print(system.tracer.report())
    s = system.stats()
    print(json.dumps({
        "frames": n, "tracked": tracked, "keyframes": s["n_keyframes"],
        "map_points": s["n_map_points"], "fps": round(n / wall, 2),
        "trajectory": args.output_addr,
    }))
    return system


if __name__ == "__main__":
    main()
