#!/usr/bin/env python3
"""Headless map inspector of the PyTorch/CUDA port: load a .map, report
statistics and the reprojection error.

The twin of display_map.py over asdslam_torch's ``mapping/persistence.py``
(the reference's display_map tool, src/display_map/src/main.cc:89-131, minus
RViz): per-frame and average reprojection error of all map-point
observations, map extent, pose-graph size; optionally the trajectory and
point cloud as PLY.  The arithmetic is display_map.py's, on the host, so the
JSON line is the same for the same file.  Like every entry point of the
port it refuses ``--device cuda`` (the default) where there is no card.

    python display_map_torch.py run.map --ply run.ply
"""

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("map_path")
    p.add_argument("--ply", default="", help="write trajectory+points PLY here")
    p.add_argument("--per_frame", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from asdslam_torch.mapping import persistence
    from asdslam_torch.mapping.persistence import _R_from_quat
    from asdslam_torch.system import require_device

    require_device(args.device)
    data = persistence.load_visual_map(args.map_path)
    n_obs_total = 0
    err_total = 0.0
    per_frame = []
    for fr in data.frames:
        Rwc = _R_from_quat(fr["direction"])
        twc = fr["position"]
        R = Rwc.T
        t = -R @ twc
        obs = fr["obs_mp"]
        sel = obs >= 0
        if not sel.any():
            per_frame.append((fr["file_name"], 0, 0.0))
            continue
        X = data.mp_positions[obs[sel]]
        xc = X @ R.T + t
        z = np.clip(xc[:, 2], 1e-6, None)
        uv = (xc[:, :2] / z[:, None]) * [fr["fx"], fr["fy"]] + [fr["cx"], fr["cy"]]
        e = np.linalg.norm(uv - fr["kps"][sel], axis=1)
        per_frame.append((fr["file_name"], int(sel.sum()), float(e.mean())))
        n_obs_total += int(sel.sum())
        err_total += float(e.sum())

    if args.per_frame:
        for name, n, e in per_frame:
            print(f"{name}: obs={n} mean_reproj={e:.3f}px")

    centers = np.stack([f["position"] for f in data.frames]) if data.frames else np.zeros((0, 3))
    summary = {
        "frames": len(data.frames),
        "map_points": len(data.mp_positions),
        "observations": n_obs_total,
        "avg_reproj_error_px": round(err_total / max(n_obs_total, 1), 4),
        "pose_graph_edges": len(data.edge_v1),
        "trajectory_length_m": round(float(
            np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
            if len(centers) > 1 else 0.0, 2),
    }
    print(json.dumps(summary))

    if args.ply:
        with open(args.ply, "w") as f:
            n = len(data.mp_positions) + len(centers)
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {n}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                    "end_header\n")
            for p3 in data.mp_positions:
                f.write(f"{p3[0]} {p3[1]} {p3[2]} 200 200 200\n")
            for c in centers:
                f.write(f"{c[0]} {c[1]} {c[2]} 255 40 40\n")
        print(f"wrote {args.ply}")
    return summary


if __name__ == "__main__":
    main()
