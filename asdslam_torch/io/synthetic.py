"""Synthetic textured-corridor sequence renderer.

Port of ``asdslam_tpu/io/synthetic.py``: a box corridor (floor, ceiling,
two walls) with piecewise-constant hashed block textures, ray-cast per pixel
from ground-truth camera poses, optionally through a radtan lens.  It lets
the port make frames, and exact trajectories, without any dataset or JAX.

The texture hash is uint32 arithmetic in the reference; torch has no uint32
multiply, so it runs in int64, reduced to 32 bits after every multiply, and
each multiply is split in 16-bit halves so no product leaves int64's range.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from asdslam_torch.geometry import camera as camera_mod
from asdslam_torch.geometry import se3
from asdslam_torch.utils import graphs

_M32 = 0xFFFFFFFF


class Scene(NamedTuple):
    floor_y: float = 2.0
    ceil_y: float = -3.0
    left_x: float = -6.0
    right_x: float = 6.0
    back_z: float = -12.0
    front_z: float = 40.0
    tex_scale: float = 0.4     # block size in metres
    seed: int = 7


def _mul32(h, c: int):
    """(h * c) mod 2^32 for 0 <= h < 2^32 held in int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash01(ix, iy, salt):
    """Block texture value in [0, 1] of integer cells (ix, iy) held in int64.
    ``salt`` is a Python int or an integer tensor that broadcasts with them
    (one salt per pixel); like the cells it is taken mod 2^32, as the
    reference's uint32 cast of its int32 values wraps."""
    h = (_mul32(ix & _M32, 73856093) ^ _mul32(iy & _M32, 19349663)
         ^ _mul32(salt & _M32, 83492791))
    h = _mul32(h, 2654435761)
    h = h ^ (h >> 13)
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) * float(np.float32(1.0 / 65535.0))


def _plane_texture(a, b, scale, salt):
    # a / scale as the reference's compiled program computes it: times the
    # f32 reciprocal.  Rays that land exactly on a block edge (whole pixel
    # columns of an axis-aligned frame) depend on that rounding.
    r1 = float(np.float32(1.0 / scale))
    r2 = float(np.float32(1.0 / (scale * 3.7)))
    v = _hash01(torch.floor(a * r1).to(torch.int64), torch.floor(b * r1).to(torch.int64), salt)
    # mix two block scales for richer structure
    v2 = _hash01(torch.floor(a * r2).to(torch.int64), torch.floor(b * r2).to(torch.int64),
                 salt + 17)
    return 0.25 + 0.5 * (0.65 * v + 0.35 * v2)


def render_frame(pose7, K, height: int, width: int, scene: Scene = Scene(),
                 dist: tuple = None):
    """Render one [H, W] grayscale frame in [0, 1] from camera pose T_cw, on
    the pose's device.

    dist: optional radtan (k1, k2, p1, p2): renders the scene as seen
    through a distorting lens.  Pixel (u, v) carries DISTORTED normalized
    coords, so the true ray direction is their radtan inverse (what
    cv::undistortPoints would recover).

    The intrinsics and the lens go to the pose's device here, outside the
    captured program (inside a capture a host-to-device copy is refused)."""
    dev = pose7.device
    K = torch.as_tensor(K, dtype=torch.float32).to(dev)
    lens = None
    if dist is not None and any(abs(k) > 1e-12 for k in dist):
        lens = camera_mod.Camera.create(1.0, 1.0, 0.0, 0.0, *dist, device=dev)
    return _render_frame(pose7, K, height, width, scene, lens)


def _frame(pose7, K, height: int, width: int, scene: Scene, lens):
    """``render_frame`` on device tensors: ``lens`` a unit ``Camera`` of the
    radtan coefficients, or None for a pinhole."""
    dev = pose7.device
    R, t = se3.pose_unpack(pose7)
    c = -(R.T @ t)  # camera centre in world
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    xn = (u - K[0, 2]) / K[0, 0]
    yn = (v - K[1, 2]) / K[1, 1]
    if lens is not None:
        und = camera_mod.undistort_normalized(lens, torch.stack([xn, yn], dim=-1))
        xn, yn = und[..., 0], und[..., 1]
    d_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    d = d_cam @ R  # world ray directions (R^T d_cam)
    t_hit, which = _ray_hits(c, d, scene)
    p = c + t_hit[..., None] * d

    s = scene.tex_scale
    tex = torch.stack([
        _plane_texture(p[..., 0], p[..., 2], s, 1),
        _plane_texture(p[..., 0], p[..., 2], s, 2),
        _plane_texture(p[..., 1], p[..., 2], s, 3),
        _plane_texture(p[..., 1], p[..., 2], s, 4),
        _plane_texture(p[..., 0], p[..., 1], s, 5),
        _plane_texture(p[..., 0], p[..., 1], s, 6),
    ], dim=-1)
    img = torch.gather(tex, -1, which[..., None])[..., 0]
    # mild distance shading for photometric variety
    img = img * (1.0 / (1.0 + 0.015 * t_hit))
    return torch.clamp(img, 0.0, 1.0)


# The renderer as one program (the reference jits render_frame,
# asdslam_tpu/io/synthetic.py:55): a key per shape, scene and lens
_render_frame = graphs.captured(_frame, "render_frame")


def _ray_hits(c, d, scene: Scene):
    """Distance along rays ``d`` [..., 3] from centre ``c`` [3] to the
    corridor's first wall, and which wall (floor, ceiling, left, right, back,
    front)."""
    big = 1e9

    def plane_t(axis, value):
        denom = d[..., axis]
        denom = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
        tt = (value - c[axis]) / denom
        return torch.where(tt > 1e-3, tt, big)

    ts = torch.stack([plane_t(1, scene.floor_y), plane_t(1, scene.ceil_y),
                      plane_t(0, scene.left_x), plane_t(0, scene.right_x),
                      plane_t(2, scene.back_z), plane_t(2, scene.front_z)], dim=-1)
    return torch.min(ts, dim=-1)


def backproject(pose7, K, uv, scene: Scene = Scene()):
    """World points [M, 3] that pixels ``uv`` [M, 2] of a frame at pose T_cw
    see: the scene geometry behind ``render_frame``, for building map-point
    state consistent with rendered frames."""
    K = torch.as_tensor(K, dtype=torch.float32).to(uv.device)
    R, t = se3.pose_unpack(pose7)
    c = -(R.T @ t)
    d_cam = torch.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1],
                         torch.ones_like(uv[:, 0])], dim=-1)
    d = d_cam @ R
    t_hit, _ = _ray_hits(c, d, scene)
    return c + t_hit[:, None] * d


def map_points(pose7, K, uv, level, valid, scale_factor: float, n_levels: int,
               scene: Scene = Scene()):
    """Map-point geometry for keypoints observed in a frame at pose T_cw:
    (pos [M, 3], normal [M, 3], min_dist [M], max_dist [M], valid [M]), the
    fields of a ``GeomBlock``.  The normal is the unit viewing direction and
    the distance range that of MapPoint::UpdateNormalAndDepth: max_dist =
    dist * scale_factor^level, min_dist = max_dist / scale_factor^(n_levels-1)."""
    pos = backproject(pose7, K, uv, scene)
    R, t = se3.pose_unpack(pose7)
    pc = pos - (-(R.T @ t))
    dist = torch.linalg.norm(pc, dim=1)
    normal = pc / dist[:, None]
    max_dist = dist * scale_factor ** level.to(torch.float32)
    min_dist = max_dist / scale_factor ** (n_levels - 1)
    return pos, normal, min_dist, max_dist, valid.clone()


def make_trajectory(n_frames: int, step: float = 0.25, turn: float = 0.0,
                    device="cuda"):
    """Ground-truth T_cw poses [n_frames, 7] moving forward along +z, with an
    optional yaw rate."""
    poses = []
    p = se3.pose_identity(device=device)
    xi = torch.tensor([0.0, turn, 0.0, 0.0, 0.0, -step], dtype=torch.float32,
                      device=device)
    for _ in range(n_frames):
        poses.append(p)
        # T_cw(next) = exp(-motion in camera frame) * T_cw
        p = se3.pose_retract(p, xi)
    return torch.stack(poses)


def render_sequence(K, n_frames: int, height: int, width: int,
                    step: float = 0.25, turn: float = 0.0, scene: Scene = Scene(),
                    dist: tuple = None, device="cuda"):
    """(frames [n, H, W] in [0, 1], poses [n, 7]) on ``device``; ``dist`` as
    in ``render_frame``."""
    poses = make_trajectory(n_frames, step, turn, device=device)
    frames = [render_frame(poses[i], K, height, width, scene, dist=dist)
              for i in range(n_frames)]
    return torch.stack(frames), poses
