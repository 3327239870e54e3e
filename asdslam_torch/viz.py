"""Headless visualization sink: the port's copy of ``asdslam_tpu/viz.py``,
the analog of the reference's RViz publishing layer.

Reference parity targets:
  * ``RVizVisualizationSink::init/publish`` — a process-wide named-topic
    publishing singleton (src/visualization/include/visualization/
    rviz-visualization-sink.h:27-64).
  * ``publish3DPointsAsPointCloud`` / ``publishLines`` /
    ``publishVerticesFromPoseVector`` helper free functions
    (src/visualization/include/visualization/common-rviz-visualization.h:29-60).
  * The live per-frame debug stream the Examples publish while tracking
    (Examples/Monocular/kitti.cc:30-53, 146-152: trajectory + map cloud +
    debug image topics).
  * ``display_map``'s offline map view: trajectory, map points, covisibility
    edges (src/display_map/src/main.cc:89-131).

There is no ROS master, so "publishing" writes standard-format artifacts
under an output directory, one sub-directory per topic, sequenced by publish
index: point clouds and line sets as PLY, pose vectors as TUM text, images
as PNG (a dependency-free zlib writer).  ``render_topdown`` rasterizes a
top-down map view (trajectory + points + covisibility) so that a tracking
run can emit an RViz-like animation headlessly.

Everything here is host-side numpy over the port's ``MapStore``: the files
are byte for byte the reference's for the same inputs.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from asdslam_torch.mapping.map_store import _pose_np


# --------------------------------------------------------------------------- #
# Encoders (dependency-free)
# --------------------------------------------------------------------------- #
def write_png_gray(path: str, img: np.ndarray):
    """Write a [H, W] uint8 (or 0..1 float) grayscale PNG (zlib, no deps)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(np.asarray(a, np.float32) * 255.0, 0, 255).astype(np.uint8)
    h, w = a.shape
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_ply_points(path: str, xyz: np.ndarray,
                     intensity: Optional[np.ndarray] = None):
    """ASCII PLY point cloud, optional per-point gray intensity (0..1)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(xyz)}",
             "property float x", "property float y", "property float z"]
    if intensity is not None:
        g = np.clip(np.asarray(intensity, np.float32) * 255.0, 0, 255
                    ).astype(np.uint8)
        assert len(g) == len(xyz), (
            f"intensity length {len(g)} != point count {len(xyz)}")
        lines += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    lines.append("end_header")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for i, p in enumerate(xyz):
            row = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if intensity is not None:
                row += f" {g[i]} {g[i]} {g[i]}"
            f.write(row + "\n")


def write_ply_lines(path: str, starts: np.ndarray, ends: np.ndarray):
    """ASCII PLY line set (edge elements) — publishLines analog."""
    starts = np.asarray(starts, np.float32).reshape(-1, 3)
    ends = np.asarray(ends, np.float32).reshape(-1, 3)
    assert len(starts) == len(ends)
    verts = np.concatenate([starts, ends], axis=0)
    n = len(starts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {2 * n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element edge {n}\n"
                "property int vertex1\nproperty int vertex2\nend_header\n")
        for p in verts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for i in range(n):
            f.write(f"{i} {i + n}\n")


# --------------------------------------------------------------------------- #
# Sink singleton
# --------------------------------------------------------------------------- #
class VisualizationSink:
    """Named-topic publisher — RVizVisualizationSink parity
    (rviz-visualization-sink.h:27-64): ``init`` once per process, then
    ``publish(topic, payload)`` from anywhere.  Each topic gets a directory;
    payloads are sequenced ``%06d.<ext>`` by per-topic publish count."""

    _out_dir: Optional[str] = None
    _seq: Dict[str, int] = {}

    @classmethod
    def init(cls, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        cls._out_dir = out_dir
        cls._seq = {}

    @classmethod
    def initialized(cls) -> bool:
        return cls._out_dir is not None

    @classmethod
    def reset(cls):
        cls._out_dir = None
        cls._seq = {}

    @classmethod
    def _path(cls, topic: str, ext: str) -> Optional[str]:
        if cls._out_dir is None:
            return None          # like publishing with no ROS master: no-op
        d = os.path.join(cls._out_dir, topic)
        os.makedirs(d, exist_ok=True)
        i = cls._seq.get(topic, 0)
        cls._seq[topic] = i + 1
        return os.path.join(d, f"{i:06d}.{ext}")

    # -- typed publishes ---------------------------------------------------- #
    @classmethod
    def publish_points(cls, topic: str, xyz, intensity=None):
        p = cls._path(topic, "ply")
        if p:
            write_ply_points(p, xyz, intensity)
        return p

    @classmethod
    def publish_lines(cls, topic: str, starts, ends):
        p = cls._path(topic, "ply")
        if p:
            write_ply_lines(p, starts, ends)
        return p

    @classmethod
    def publish_poses(cls, topic: str, pose7s, ids=None):
        """Pose vector as TUM rows ``id tx ty tz qx qy qz qw`` (camera-in-
        world) — publishVerticesFromPoseVector analog."""
        p = cls._path(topic, "txt")
        if p is None:
            return None
        pose7s = np.asarray(pose7s, np.float32).reshape(-1, 7)
        ids = np.arange(len(pose7s)) if ids is None else np.asarray(ids)
        with open(p, "w") as f:
            for i, pw in zip(ids, pose7s):
                R, t = _pose_np(pw)          # T_cw
                c = -R.T @ t                 # camera centre in world
                qw, qx, qy, qz = pw[:4]
                f.write(f"{i} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                        f"{-qx:.6f} {-qy:.6f} {-qz:.6f} {qw:.6f}\n")
        return p

    @classmethod
    def publish_image(cls, topic: str, img):
        p = cls._path(topic, "png")
        if p:
            write_png_gray(p, img)
        return p

    @classmethod
    def publish_json(cls, topic: str, obj):
        p = cls._path(topic, "json")
        if p:
            with open(p, "w") as f:
                json.dump(obj, f)
        return p


# Free-function helpers with reference-parity names
# (common-rviz-visualization.h:29-60).
def publish_3d_points_as_point_cloud(xyz, topic: str, intensity=None):
    return VisualizationSink.publish_points(topic, xyz, intensity)


def publish_lines(starts, ends, topic: str):
    return VisualizationSink.publish_lines(topic, starts, ends)


def publish_vertices_from_pose_vector(pose7s, topic: str, ids=None):
    return VisualizationSink.publish_poses(topic, pose7s, ids)


# --------------------------------------------------------------------------- #
# Map snapshots
# --------------------------------------------------------------------------- #
def covisibility_segments(store, min_weight: int = 30):
    """(starts, ends) world-space segments between covisible KF centres —
    display_map's covisibility view (weight gate matches the saved
    pose-graph edge threshold, System.cc:407)."""
    kfs = np.flatnonzero(store.kf_valid)
    starts, ends = [], []
    for k in kfs:
        for j, w in store.covisibility_weights(int(k)).items():
            if j > k and w >= min_weight and store.kf_valid[j]:
                starts.append(store.kf_center[k])
                ends.append(store.kf_center[j])
    if not starts:
        z = np.zeros((0, 3), np.float32)
        return z, z
    return np.asarray(starts, np.float32), np.asarray(ends, np.float32)


def publish_map_snapshot(store, prefix: str = "map", min_covis_weight: int = 30):
    """Publish the current map state: trajectory vertices, map-point cloud,
    covisibility line set (kitti.cc:146-152 / display_map main.cc:89-131)."""
    if not VisualizationSink.initialized():
        return
    kfs = np.flatnonzero(store.kf_valid)
    if len(kfs):
        VisualizationSink.publish_poses(
            f"{prefix}/trajectory", store.kf_pose[kfs], ids=store.kf_frame_id[kfs])
    mps = np.flatnonzero(store.mp_valid)
    if len(mps):
        VisualizationSink.publish_points(f"{prefix}/points", store.mp_pos[mps])
    s, e = covisibility_segments(store, min_covis_weight)
    if len(s):
        VisualizationSink.publish_lines(f"{prefix}/covisibility", s, e)


def render_topdown(store, size: int = 720, margin: float = 0.07,
                   trajectory=None, min_covis_weight: int = 30,
                   covis_segments=None) -> np.ndarray:
    """Rasterize a live top-down (x-z plane; KITTI y is down) map view:
    map points (gray), KF centres (white), covisibility edges (dim),
    current frame trajectory (bright polyline).  Pure numpy; returns
    [size, size] uint8 — the headless stand-in for the RViz viewport.

    min_covis_weight must match the value used by publish_map_snapshot for
    the PLY edge set and the rendered view to agree; pass precomputed
    ``covis_segments=(starts, ends)`` to avoid recomputing them twice."""
    img = np.zeros((size, size), np.float32)
    mps = store.mp_pos[store.mp_valid]
    kfc = store.kf_center[store.kf_valid]
    pts = [p for p in (mps, kfc) if len(p)]
    if trajectory is not None and len(trajectory):
        pts.append(np.asarray(trajectory, np.float32))
    if not pts:
        return np.zeros((size, size), np.uint8)
    allp = np.concatenate(pts, axis=0)[:, [0, 2]]
    lo = np.percentile(allp, 1, axis=0)
    hi = np.percentile(allp, 99, axis=0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-3))
    pad = span * margin
    lo = lo - pad
    scale = (size - 1) / (span + 2 * pad)

    def to_px(xz):
        p = np.clip((np.asarray(xz) - lo) * scale, 0, size - 1).astype(np.int32)
        return p[:, 0], size - 1 - p[:, 1]

    if len(mps):
        u, v = to_px(mps[:, [0, 2]])
        np.add.at(img, (v, u), 0.35)
    s, e = (covis_segments if covis_segments is not None
            else covisibility_segments(store, min_covis_weight))
    for a, b in zip(s, e):
        n = max(2, int(np.hypot(*(b - a)[[0, 2]] * scale)) + 1)
        seg = a[None, [0, 2]] + np.linspace(0, 1, n)[:, None] * (b - a)[None, [0, 2]]
        u, v = to_px(seg)
        img[v, u] = np.maximum(img[v, u], 0.25)
    if trajectory is not None and len(trajectory) > 1:
        t = np.asarray(trajectory, np.float32)[:, [0, 2]]
        for i in range(len(t) - 1):
            n = max(2, int(np.hypot(*((t[i + 1] - t[i]) * scale))) + 1)
            seg = t[i][None] + np.linspace(0, 1, n)[:, None] * (t[i + 1] - t[i])[None]
            u, v = to_px(seg)
            img[v, u] = 0.8
    if len(kfc):
        u, v = to_px(kfc[:, [0, 2]])
        img[v, u] = 1.0
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)
