"""KITTI proxy sequences: full-resolution textured renders along the real
KITTI ground-truth trajectories.

Port of ``asdslam_tpu/io/kitti_proxy.py``.  A procedural street world of
axis-aligned textured boxes (road slabs following the path's elevation,
"building" blocks flanking the street) is ray-cast per pixel along a real
KITTI ground-truth path (TUM format) with the real camera intrinsics at
1241x376: real vehicle dynamics, synthetic appearance.  The ground-truth and
camera files are read from ``GT_DIR`` / ``CAM_DIR`` under ``reference/`` in
this repository, in the reference repository's own layout; until those files
are committed there, a sequence cannot be built.

The world model, the box selection and the trajectory reader are numpy and
copied; ``raycast_grid`` and ``render_boxes`` run in torch on the device of
their grid (the reference's ``lax.scan`` over the boxes is a broadcast over
chunks of boxes here).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from asdslam_torch.geometry import se3
from asdslam_torch.io.synthetic import _hash01
from asdslam_torch.utils import graphs

# the KITTI ground-truth trajectories and camera files of the reference
# repository (ASD-SLAM), in its layout under this repository's reference/
REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "reference")
GT_DIR = os.path.join(REFERENCE_DIR, "experiment_result", "asnd")
CAM_DIR = os.path.join(REFERENCE_DIR, "cameraconfig", "KITTI")

CAMERA_HEIGHT = 1.65          # KITTI left-gray camera above road (metres)

SEQ_CAMCFG = {
    "00": "kitti00-02.txt", "01": "kitti00-02.txt", "02": "kitti00-02.txt",
    "03": "kitti03.txt",
    **{f"{i:02d}": "kitti04-12.txt" for i in range(4, 13)},
}


# --------------------------------------------------------------------------- #
# Ground truth
# --------------------------------------------------------------------------- #
def load_tum_trajectory(path: str):
    """TUM `ts tx ty tz qx qy qz qw` -> (ts [N], pose7_cw [N, 7], centers [N, 3]).

    The stored pose is T_wc (camera position/orientation in the world = the
    t=0 camera frame: x right, y down, z forward).  pose7 is our packed T_cw
    (w, x, y, z, tx, ty, tz)."""
    d = np.loadtxt(path, dtype=np.float64)
    ts = d[:, 0]
    t_wc = d[:, 1:4]
    q = d[:, 4:8]  # x, y, z, w
    w, x, y, z = q[:, 3], q[:, 0], q[:, 1], q[:, 2]
    R_wc = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, t_wc)
    # quat of R_cw = conjugate of (w, x, y, z)
    q_cw = np.stack([w, -x, -y, -z], axis=1)
    q_cw /= np.linalg.norm(q_cw, axis=1, keepdims=True)
    pose7 = np.concatenate([q_cw, t_cw], axis=1).astype(np.float32)
    return ts, pose7, t_wc.astype(np.float32)


def gt_path(seq: str) -> str:
    return os.path.join(GT_DIR, f"nvidia_asnd_KITTI{seq}", "stamped_groundtruth.txt")


def camera_config_path(seq: str) -> str:
    return os.path.join(CAM_DIR, SEQ_CAMCFG[seq])


# --------------------------------------------------------------------------- #
# World construction
# --------------------------------------------------------------------------- #
class World(NamedTuple):
    bmin: np.ndarray   # [B, 3]
    bmax: np.ndarray   # [B, 3]
    salt: np.ndarray   # [B] int32 texture seed per box


def build_world(centers: np.ndarray, seed: int = 3,
                road_spacing: float = 4.0, building_spacing: float = 6.0,
                lateral_min: float = 7.0, lateral_max: float = 15.0) -> World:
    """Procedural street world along the camera path.

    centers: [N, 3] camera positions in world (y DOWN).  Road slabs follow
    the elevation profile (ground = camera y + CAMERA_HEIGHT); building
    boxes flank the street at lateral offsets, culled if they'd intersect
    the path corridor."""
    rng = np.random.default_rng(seed)
    # resample path by arc length
    seg = np.linalg.norm(np.diff(centers, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(s[-1])

    def sample(spacing):
        si = np.arange(0.0, total, spacing)
        p = np.stack([np.interp(si, s, centers[:, k]) for k in range(3)], 1)
        # horizontal tangent for lateral placement
        tang = np.gradient(p, axis=0)
        tang[:, 1] = 0.0
        n = np.linalg.norm(tang, axis=1, keepdims=True)
        tang = tang / np.maximum(n, 1e-6)
        lat = np.stack([-tang[:, 2], np.zeros(len(p)), tang[:, 0]], 1)
        return p, lat

    bmins, bmaxs, salts = [], [], []

    # road slabs: thin boxes under the path (footprint covers the street)
    road_p, _ = sample(road_spacing)
    ground_y = road_p[:, 1] + CAMERA_HEIGHT
    half = road_spacing * 1.6
    for i, p in enumerate(road_p):
        bmins.append([p[0] - half, ground_y[i], p[2] - half])
        bmaxs.append([p[0] + half, ground_y[i] + 0.3, p[2] + half])
        salts.append(1000 + i)

    # buildings, both sides of the street
    b_p, b_lat = sample(building_spacing)
    path2d = centers[:, [0, 2]]
    for i, p in enumerate(b_p):
        gy = p[1] + CAMERA_HEIGHT
        for side in (-1.0, 1.0):
            off = rng.uniform(lateral_min, lateral_max)
            c = p + side * off * b_lat[i]
            hw = rng.uniform(2.0, 5.0)     # half footprint
            h = rng.uniform(4.0, 13.0)     # height
            # cull if the footprint encroaches on the path corridor
            d2 = np.min(np.linalg.norm(path2d - c[[0, 2]], axis=1))
            if d2 < hw + 4.5:
                continue
            bmins.append([c[0] - hw, gy - h, c[2] - hw])
            bmaxs.append([c[0] + hw, gy + 1.0, c[2] + hw])
            salts.append(i * 2 + (side > 0))

    return World(np.asarray(bmins, np.float32), np.asarray(bmaxs, np.float32),
                 np.asarray(salts, np.int32))


def select_boxes(world: World, cam_center: np.ndarray, k: int) -> World:
    """Nearest-k boxes to the camera — fixed-size render block."""
    c = np.asarray(cam_center, np.float32)
    mid = 0.5 * (world.bmin + world.bmax)
    d = np.linalg.norm(mid - c[None, :], axis=1)
    if len(d) <= k:
        pad = k - len(d)
        # pad with degenerate far-away boxes
        far = np.full((pad, 3), 1e7, np.float32)
        return World(np.concatenate([world.bmin, far]),
                     np.concatenate([world.bmax, far]),
                     np.concatenate([world.salt, np.zeros(pad, np.int32)]))
    idx = np.argpartition(d, k)[:k]
    return World(world.bmin[idx], world.bmax[idx], world.salt[idx])


# --------------------------------------------------------------------------- #
# Renderer
# --------------------------------------------------------------------------- #
def render_boxes(pose7, K, bmin, bmax, salt, height: int, width: int,
                 tex_scale: float = 0.35, return_depth: bool = False):
    """Ray-cast the box world from camera pose T_cw -> [H, W] grayscale, on
    the pose's device.

    return_depth: also return the per-pixel ray-hit parameter t (distance
    along the unit-z-normalized camera ray; BIG where the sky is hit)."""
    dev = pose7.device
    return _render_boxes(_on(pose7, dev), torch.as_tensor(K, dtype=torch.float32).to(dev),
                         *_boxes_on(bmin, bmax, salt, dev), height, width, tex_scale,
                         return_depth)


def _on(pose7, dev):
    return torch.as_tensor(pose7, dtype=torch.float32).to(dev)


def _boxes_on(bmin, bmax, salt, dev):
    """The boxes (numpy or tensors) as f32 corners and int64 salts on
    ``dev``: copied here, outside the captured programs, which may not copy
    from the host."""
    return (torch.as_tensor(bmin, dtype=torch.float32).to(dev),
            torch.as_tensor(bmax, dtype=torch.float32).to(dev),
            torch.as_tensor(salt).to(dev).to(torch.int64))


def _boxes_frame(pose7, K, bmin, bmax, salt, height: int, width: int, tex_scale: float,
                 return_depth: bool):
    """``render_boxes`` on device tensors: the pinhole grid, then the
    ray-caster."""
    dev = pose7.device
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    xn = (u - K[0, 2]) / K[0, 0]
    yn = (v - K[1, 2]) / K[1, 1]
    return _raycast(pose7, xn, yn, bmin, bmax, salt, tex_scale, return_depth)


# ray-box pairs a chunk of raycast_grid holds: ~12 chunks of 8 boxes a
# 1241x376 frame, about 50 MB for each [C, 3, H, W] temporary
CHUNK_PAIRS = 1 << 22


def _int32_floor(x):
    """floor(x) converted to int32 as XLA converts (saturating, NaN to 0),
    held in int64."""
    f = torch.nan_to_num(torch.floor(x).to(torch.float64), nan=0.0)
    return f.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def raycast_grid(pose7, xn, yn, bmin, bmax, salt, tex_scale: float = 0.35,
                 return_depth: bool = False):
    """Ray-caster over a normalized-coordinate grid (xn, yn [H, W], on the
    render's device): pinhole rendering passes the ideal grid; a distorted
    camera (EuRoC radtan, euroc_proxy.py) passes the undistorted-pixel grid
    so the rendered image exhibits the lens distortion.  bmin, bmax [B, 3]
    and salt [B] are the boxes (numpy or tensors); the first box along each
    ray wins, the earlier box on a tie, as the reference's scan."""
    dev = xn.device
    return _raycast_grid(_on(pose7, dev), xn, yn, *_boxes_on(bmin, bmax, salt, dev),
                         tex_scale, return_depth)


def _raycast(pose7, xn, yn, bmin, bmax, salt, tex_scale: float, return_depth: bool):
    """``raycast_grid`` on device tensors (``_boxes_on``'s boxes)."""
    dev = xn.device
    R, t = se3.pose_unpack(pose7)
    # R^T t and R^T d_cam as sums of elementwise products in a fixed order,
    # each rounded on its own, so that the card's frames are the CPU's: a
    # matrix product rounds as its library pleases (cuBLAS and the CPU's
    # BLAS part in the last bit, and a ray moved by a bit can cross a
    # texture cell's edge)
    c = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])
    d = torch.stack([xn * R[0, i] + yn * R[1, i] + R[2, i] for i in range(3)], dim=-1)
    inv_d = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    inv_d = inv_d.permute(2, 0, 1)                               # [3, H, W]
    # [B, 3] box corners relative to the camera
    lo = bmin - c
    hi = bmax - c

    # The nearest hit over chunks of boxes, about CHUNK_PAIRS ray-box pairs
    # each: min() takes the first box of equal t within a chunk and the
    # strict < keeps the earlier chunk's, as the scan's strict < does.
    BIG = 1e8
    t_hit = torch.full(xn.shape, BIG, dtype=torch.float32, device=dev)
    box_hit = torch.zeros(xn.shape, dtype=torch.int64, device=dev)
    step = max(1, CHUNK_PAIRS // xn.numel())
    for b0 in range(0, salt.shape[0], step):
        t1 = lo[b0:b0 + step, :, None, None] * inv_d             # [C, 3, H, W]
        t2 = hi[b0:b0 + step, :, None, None] * inv_d
        tn = torch.minimum(t1, t2).amax(1)
        tf = torch.maximum(t1, t2).amin(1)
        t_near, b = torch.where(tf > tn.clamp(min=1e-3), tn, torch.inf).min(0)
        hit = t_near < t_hit
        t_hit = torch.where(hit, t_near, t_hit)
        box_hit = torch.where(hit, b + b0, box_hit)
    # the winner's salt and entry axis (the first maximum, as argmax takes
    # it); where nothing is hit these read box 0 and the sky covers them
    salt_hit = salt[box_hit]
    axis_hit = torch.minimum(lo[box_hit].permute(2, 0, 1) * inv_d,
                             hi[box_hit].permute(2, 0, 1) * inv_d).argmax(0)

    p = c + t_hit[..., None] * d
    # texture coords: the two axes orthogonal to the entry face
    # (x-face -> (y, z), y-face -> (x, z), z-face -> (x, y))
    sel_a = torch.where(axis_hit == 0, p[..., 1], p[..., 0])
    sel_b = torch.where(axis_hit == 2, p[..., 1], p[..., 2])

    # three value-noise octaves, each keyed on the box id (a per-pixel salt).
    # The cell size is a tensor on the device: divided by a Python float, a
    # CUDA tensor is multiplied by the float's reciprocal instead, which
    # moves a texture coordinate by a bit where the CPU's quotient does not
    def octave(mul, ds):
        s = torch.full((), float(np.float32(tex_scale) * np.float32(mul)), device=dev)
        return _hash01(_int32_floor(sel_a / s), _int32_floor(sel_b / s), salt_hit + ds)

    v_base = octave(1.0, 1)
    v_coarse = octave(3.7, 17)
    v_fine = octave(0.3, 29)
    w_fine = torch.sigmoid((18.0 - t_hit) * 0.25)
    tex = 0.40 * v_base + 0.30 * v_coarse + 0.30 * (w_fine * v_fine + (1.0 - w_fine) * 0.5)
    # per-box albedo for inter-box brightness contrast
    salt_f = torch.remainder(salt_hit.to(torch.float32) * 0.618, 1.0)
    img = 0.18 + 0.62 * tex + 0.08 * salt_f
    img = img * (1.0 / (1.0 + 0.006 * t_hit))   # distance shading
    sky = 0.72 + 0.06 * yn                       # featureless gradient
    img = torch.where(t_hit >= BIG, sky, img).clamp(0.0, 1.0)
    if return_depth:
        return img, t_hit
    return img


# The renderers as programs (the reference jits both,
# asdslam_tpu/io/kitti_proxy.py:170 and :186): a sequence's box count is
# fixed, so one key serves its frames (two with and without depth)
_render_boxes = graphs.captured(_boxes_frame, "render_boxes")
_raycast_grid = graphs.captured(_raycast, "raycast_grid")


# --------------------------------------------------------------------------- #
# Sequence facade
# --------------------------------------------------------------------------- #
class KittiProxySequence:
    """Lazily rendered proxy sequence: seq[i] -> (timestamp, [H, W] image on
    ``device``).

    scale: render at reduced resolution with proportionally scaled
    intrinsics (tests); 1.0 = the real 1241x376."""

    def __init__(self, seq: str = "03", scale: float = 1.0, n_boxes: int = 256,
                 max_frames: int = None, seed: int = 3, device="cuda"):
        from asdslam_torch.io import datasets
        self.seq = seq
        self.device = torch.device(device)
        info = datasets.read_cam_info(camera_config_path(seq))
        self.width = int(round(1241 * scale))
        self.height = int(round(376 * scale))
        self.fx = info["fx"] * scale
        self.fy = info["fy"] * scale
        self.cx = info["cx"] * scale
        self.cy = info["cy"] * scale
        self.K = torch.tensor([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]],
                              dtype=torch.float32, device=self.device)
        ts, pose7, centers = load_tum_trajectory(gt_path(seq))
        # the world is always built from the full path (a short tracked
        # prefix must still see the street continuing ahead)
        self.world = build_world(centers, seed=seed)
        if max_frames:
            ts, pose7, centers = ts[:max_frames], pose7[:max_frames], centers[:max_frames]
        self.timestamps = ts
        self.gt_pose7 = pose7
        self.centers = centers
        self.n_boxes = min(n_boxes, len(self.world.salt))

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        w = select_boxes(self.world, self.centers[i], self.n_boxes)
        img = render_boxes(torch.as_tensor(self.gt_pose7[i]).to(self.device), self.K,
                           w.bmin, w.bmax, w.salt, self.height, self.width)
        return float(self.timestamps[i]), img

    def config(self, base=None, **kw):
        from asdslam_torch.config import SlamConfig
        base = base or SlamConfig()
        return base.replace(image_width=self.width, image_height=self.height,
                            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, **kw)
