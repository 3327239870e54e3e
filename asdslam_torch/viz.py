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

``draw_debug_overlay`` draws System::getDebugImg's overlay (observed
keypoints, their reprojections, a caption band) into an RGB array with a
small bitmap font, for ``write_png_rgb``: the port needs no matplotlib.

Everything here is host-side numpy over the port's ``MapStore``: the files
of the sink are byte for byte the reference's for the same inputs.
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
def _png_chunk(tag: bytes, data: bytes) -> bytes:
    c = struct.pack(">I", len(data)) + tag + data
    return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _write_png(path: str, a: np.ndarray, colour_type: int, text: Optional[str] = None):
    """An 8-bit PNG of ``a`` ([H, W] gray or [H, W, 3] RGB, uint8), filter 0
    on every row, with an optional ``tEXt`` "Title" chunk."""
    h, w = a.shape[:2]
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)))
        if text is not None:
            f.write(_png_chunk(b"tEXt", b"Title\x00" + text.encode("latin-1")))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def _to_u8(img) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(np.asarray(a, np.float32) * 255.0, 0, 255).astype(np.uint8)
    return a


def write_png_gray(path: str, img: np.ndarray):
    """Write a [H, W] uint8 (or 0..1 float) grayscale PNG (zlib, no deps)."""
    _write_png(path, _to_u8(img), colour_type=0)


def write_png_rgb(path: str, img_u8: np.ndarray, text: Optional[str] = None):
    """Write a [H, W, 3] uint8 RGB PNG (colour type 2); ``text`` goes into a
    ``tEXt`` chunk under the keyword "Title"."""
    a = np.ascontiguousarray(img_u8, np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"write_png_rgb takes [H, W, 3], got {a.shape}")
    _write_png(path, a, colour_type=2, text=text)


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


# --------------------------------------------------------------------------- #
# The debug overlay (System::getDebugImg)
# --------------------------------------------------------------------------- #
# 5x7 bitmap glyphs for the characters of the overlay's strings: the title
# "reproj err %.2f px, %d matches, %d KFs, %d MPs" (with "nan" / "inf" for
# the error) and the legend words "observed" and "reprojected".
_GLYPH_ROWS = {
    " ": ".....|.....|.....|.....|.....|.....|.....",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####",
    "3": "#####|...#.|..#..|...#.|....#|#...#|.###.",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.",
    "5": "#####|#....|####.|....#|....#|#...#|.###.",
    "6": "..##.|.#...|#....|####.|#...#|#...#|.###.",
    "7": "#####|....#|...#.|..#..|.#...|.#...|.#...",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.",
    "9": ".###.|#...#|#...#|.####|....#|...#.|.##..",
    ".": ".....|.....|.....|.....|.....|.##..|.##..",
    ",": ".....|.....|.....|.....|.##..|..#..|.#...",
    "-": ".....|.....|.....|#####|.....|.....|.....",
    "a": ".....|.....|.###.|....#|.####|#...#|.####",
    "b": "#....|#....|#.##.|##..#|#...#|#...#|####.",
    "c": ".....|.....|.###.|#....|#....|#...#|.###.",
    "d": "....#|....#|.##.#|#..##|#...#|#...#|.####",
    "e": ".....|.....|.###.|#...#|#####|#....|.###.",
    "f": "..##.|.#..#|.#...|###..|.#...|.#...|.#...",
    "h": "#....|#....|#.##.|##..#|#...#|#...#|#...#",
    "i": "..#..|.....|.##..|..#..|..#..|..#..|.###.",
    "j": "...#.|.....|..##.|...#.|...#.|#..#.|.##..",
    "m": ".....|.....|##.#.|#.#.#|#.#.#|#...#|#...#",
    "n": ".....|.....|#.##.|##..#|#...#|#...#|#...#",
    "o": ".....|.....|.###.|#...#|#...#|#...#|.###.",
    "p": ".....|.....|####.|#...#|####.|#....|#....",
    "r": ".....|.....|#.##.|##..#|#....|#....|#....",
    "s": ".....|.....|.###.|#....|.###.|....#|####.",
    "t": ".#...|.#...|###..|.#...|.#...|.#..#|..##.",
    "v": ".....|.....|#...#|#...#|#...#|.#.#.|..#..",
    "x": ".....|.....|#...#|.#.#.|..#..|.#.#.|#...#",
    "F": "#####|#....|#....|####.|#....|#....|#....",
    "K": "#...#|#..#.|#.#..|##...|#.#..|#..#.|#...#",
    "M": "#...#|##.##|#.#.#|#.#.#|#...#|#...#|#...#",
    "P": "####.|#...#|#...#|####.|#....|#....|#....",
}
GLYPHS = {c: np.array([[ch == "#" for ch in row] for row in rows.split("|")])
          for c, rows in _GLYPH_ROWS.items()}
GLYPH_H, GLYPH_W, GLYPH_ADVANCE = 7, 5, 6
# the caption band under the image: the title line, then the legend line
BAND_H = 2 * (GLYPH_H + 4) + 2
LIME = (0, 255, 0)
RED = (255, 0, 0)
WHITE = (255, 255, 255)
# marker footprints as (dv, du) offsets: a disc of radius 1.5 px (the 3x3
# block) for the observed keypoints, a 5-px "x" for the reprojections
DISC = np.array([(dv, du) for dv in (-1, 0, 1) for du in (-1, 0, 1)])
CROSS = np.array([(k, k) for k in range(-2, 3)] + [(k, -k) for k in range(-2, 3) if k])


def debug_caption(info) -> str:
    """The reference's title of the debug image (system.py's set_title)."""
    return "reproj err %.2f px, %d matches, %d KFs, %d MPs" % (
        info.get("mean_reproj_err", float("nan")), info.get("n_matches", 0),
        info["n_keyframes"], info["n_map_points"])


def _paint(canvas, centres_vu, footprint, colour, rows):
    """Set ``colour`` at every pixel of ``footprint`` around each centre,
    clipped to the first ``rows`` rows and the canvas's columns."""
    if not len(centres_vu):
        return
    px = (centres_vu[:, None, :] + footprint[None]).reshape(-1, 2)
    inside = ((px[:, 0] >= 0) & (px[:, 0] < rows)
              & (px[:, 1] >= 0) & (px[:, 1] < canvas.shape[1]))
    px = px[inside]
    canvas[px[:, 0], px[:, 1]] = colour


def draw_text(canvas, x: int, y: int, text: str, colour=WHITE):
    """Draw ``text`` with the 5x7 glyphs, its top-left corner at (x, y),
    clipped to the canvas.  A character without a glyph raises."""
    h, w = canvas.shape[:2]
    for i, ch in enumerate(text):
        if ch not in GLYPHS:
            raise ValueError(f"no glyph for {ch!r}")
        vs, us = np.nonzero(GLYPHS[ch])
        vs, us = vs + y, us + x + i * GLYPH_ADVANCE
        ok = (vs >= 0) & (vs < h) & (us >= 0) & (us < w)
        canvas[vs[ok], us[ok]] = colour


def _rounded(uv, ok):
    """Rounded (v, u) int pixel centres of the finite ``uv[ok]`` rows."""
    uv = np.asarray(uv, np.float64)[np.asarray(ok, bool)]
    uv = uv[np.isfinite(uv).all(axis=1)]
    return np.rint(uv[:, ::-1]).astype(np.int64)


def draw_debug_overlay(shape, obs_uv, proj, ok, caption: str,
                       backdrop=None) -> np.ndarray:
    """The debug image of System::getDebugImg without matplotlib.

    The canvas is ``backdrop`` ([H, W] gray, 0..1 float or uint8, replicated
    to three channels) or a black [H, W] = ``shape``.  Observed keypoints
    ``obs_uv[ok]`` are lime discs of radius 1.5 px at their rounded pixel,
    then the reprojections ``proj[ok]`` red 5-px crosses over them (the
    reference's two scatters, in its order), clipped to the canvas.  Under
    the image a band of ``BAND_H`` rows holds ``caption`` and the legend
    (a lime disc "observed", a red cross "reprojected").  ``proj`` None
    draws no marker.  Returns uint8 [H + BAND_H, W, 3]."""
    if backdrop is not None:
        gray = _to_u8(backdrop)
        h, w = gray.shape
    else:
        h, w = shape
        gray = np.zeros((h, w), np.uint8)
    canvas = np.zeros((h + BAND_H, w, 3), np.uint8)
    canvas[:h] = gray[..., None]
    if proj is not None:
        _paint(canvas, _rounded(obs_uv, ok), DISC, LIME, h)
        _paint(canvas, _rounded(proj, ok), CROSS, RED, h)
    draw_text(canvas, 2, h + 3, caption)
    legend_y = h + 3 + GLYPH_H + 4
    entries = [(DISC, LIME, "observed"), (CROSS, RED, "reprojected")]
    width = sum(8 + len(word) * GLYPH_ADVANCE + 6 for _, _, word in entries)
    x = max(2, w - width)                   # lower right, as the reference's legend
    for footprint, colour, word in entries:
        centre = np.array([[legend_y + GLYPH_H // 2, x + 2]])
        _paint(canvas, centre, footprint, colour, canvas.shape[0])
        draw_text(canvas, x + 8, legend_y, word)
        x += 8 + len(word) * GLYPH_ADVANCE + 6
    return canvas
