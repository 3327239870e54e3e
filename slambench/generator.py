"""The benchmark's one traffic generator: a camera stream and its ground
truth, made from a traffic file's parameters and a seed.

A traffic file (``slambench/traffic/<mix>.json``) names a world
(``"world": "<name>"``), which ``slambench/worlds/<name>.py`` builds: its
``path(traffic, n_frames, seed)`` gives the camera's path and the centres
the world is built around, its ``build(centres, seed)`` the world's boxes.
A new world is a new file there, found by its name.

The geometry (the path and the boxes) comes from the file's ``world_seed``;
the run's seed deals the boxes' textures out anew (a permutation of the
same texture seeds).  Every seed thus sees the same street or hall, with the
same sizes and motion, in other colours: what a seed changes is the
appearance, not the amount of work, which a world drawn from the seed
changed by a tenth of the frame rate.

Frames are ray-cast on the card at the configuration's camera (its lens
distortion included) and handed over as host uint8, as a loader delivers
them.  The ray-caster is a frozen copy of the program's proxy renderer
(``asdslam_torch/io/kitti_proxy.py``, ``io/synthetic.py::_hash01``), kept
here so that a change to the program does not change the frames.
"""

from __future__ import annotations

import importlib.util
import os
from typing import NamedTuple

import numpy as np
import torch

WORLDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "worlds")
_M32 = 0xFFFFFFFF
# ray-box pairs a chunk of the ray-caster holds
CHUNK_PAIRS = 1 << 22


class World(NamedTuple):
    bmin: np.ndarray   # [B, 3]
    bmax: np.ndarray   # [B, 3]
    salt: np.ndarray   # [B] texture seed of each box


class Stream(NamedTuple):
    frames: np.ndarray     # [F, H, W] uint8
    pose7: np.ndarray      # [F, 7] ground-truth T_cw (qw, qx, qy, qz, tx, ty, tz)
    centers: np.ndarray    # [F, 3] ground-truth camera centres (y down)


def select_boxes(world: World, center: np.ndarray, k: int) -> World:
    """The k boxes nearest the camera (degenerate far boxes pad a short
    world)."""
    mid = 0.5 * (world.bmin + world.bmax)
    d = np.linalg.norm(mid - np.asarray(center, np.float32)[None, :], axis=1)
    if len(d) <= k:
        far = np.full((k - len(d), 3), 1e7, np.float32)
        return World(np.concatenate([world.bmin, far]), np.concatenate([world.bmax, far]),
                     np.concatenate([world.salt, np.zeros(k - len(d), np.int32)]))
    idx = np.argpartition(d, k)[:k]
    return World(world.bmin[idx], world.bmax[idx], world.salt[idx])


# --------------------------------------------------------------------------- #
# Camera rays and the ray-caster
# --------------------------------------------------------------------------- #
def ray_grid(width: int, height: int, fx, fy, cx, cy, dist, iters: int = 10):
    """Each pixel's normalised ray (x, y) [H, W]: the radtan model inverted
    by fixed-point steps, so a render through it carries the lens's
    distortion (the pinhole grid where the coefficients are zero)."""
    k1, k2, p1, p2 = dist
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    if any(abs(c) > 1e-12 for c in dist):
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
    return x.astype(np.float32), y.astype(np.float32)


def _mul32(h, c: int):
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash01(ix, iy, salt):
    h = (_mul32(ix & _M32, 73856093) ^ _mul32(iy & _M32, 19349663)
         ^ _mul32(salt & _M32, 83492791))
    h = _mul32(h, 2654435761)
    h = h ^ (h >> 13)
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) * float(np.float32(1.0 / 65535.0))


def _int32_floor(x):
    f = torch.nan_to_num(torch.floor(x).to(torch.float64), nan=0.0)
    return f.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def _quat_to_matrix(q):
    q = q / torch.linalg.norm(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]).reshape(3, 3)


def raycast(pose7, xn, yn, bmin, bmax, salt, tex_scale: float):
    """[H, W] gray image in [0, 1] of the boxes seen from T_cw ``pose7``
    through the ray grid (xn, yn); the first box along each ray wins."""
    dev = xn.device
    R, t = _quat_to_matrix(pose7[:4]), pose7[4:]
    c = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])
    d = torch.stack([xn * R[0, i] + yn * R[1, i] + R[2, i] for i in range(3)], dim=-1)
    inv_d = (1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)).permute(2, 0, 1)
    lo = bmin - c
    hi = bmax - c
    BIG = 1e8
    t_hit = torch.full(xn.shape, BIG, dtype=torch.float32, device=dev)
    box_hit = torch.zeros(xn.shape, dtype=torch.int64, device=dev)
    step = max(1, CHUNK_PAIRS // xn.numel())
    for b0 in range(0, salt.shape[0], step):
        t1 = lo[b0:b0 + step, :, None, None] * inv_d
        t2 = hi[b0:b0 + step, :, None, None] * inv_d
        tn = torch.minimum(t1, t2).amax(1)
        tf = torch.maximum(t1, t2).amin(1)
        t_near, b = torch.where(tf > tn.clamp(min=1e-3), tn, torch.inf).min(0)
        hit = t_near < t_hit
        t_hit = torch.where(hit, t_near, t_hit)
        box_hit = torch.where(hit, b + b0, box_hit)
    salt_hit = salt[box_hit]
    axis_hit = torch.minimum(lo[box_hit].permute(2, 0, 1) * inv_d,
                             hi[box_hit].permute(2, 0, 1) * inv_d).argmax(0)
    p = c + t_hit[..., None] * d
    sel_a = torch.where(axis_hit == 0, p[..., 1], p[..., 0])
    sel_b = torch.where(axis_hit == 2, p[..., 1], p[..., 2])

    def octave(mul, ds):
        s = torch.full((), float(np.float32(tex_scale) * np.float32(mul)), device=dev)
        return _hash01(_int32_floor(sel_a / s), _int32_floor(sel_b / s), salt_hit + ds)

    w_fine = torch.sigmoid((18.0 - t_hit) * 0.25)
    tex = (0.40 * octave(1.0, 1) + 0.30 * octave(3.7, 17)
           + 0.30 * (w_fine * octave(0.3, 29) + (1.0 - w_fine) * 0.5))
    salt_f = torch.remainder(salt_hit.to(torch.float32) * 0.618, 1.0)
    img = (0.18 + 0.62 * tex + 0.08 * salt_f) * (1.0 / (1.0 + 0.006 * t_hit))
    sky = 0.72 + 0.06 * yn
    return torch.where(t_hit >= BIG, sky, img).clamp(0.0, 1.0)


# --------------------------------------------------------------------------- #
# The stream
# --------------------------------------------------------------------------- #
def world(name: str):
    """The module ``slambench/worlds/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"slambench_world_{name}",
                                                  os.path.join(WORLDS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_stream(traffic: dict, slam: dict, n_frames: int, seed: int, device) -> Stream:
    """``n_frames`` frames of the traffic at the configuration's camera
    (``slam``: image size, intrinsics, distortion), rendered on ``device``
    from ``seed``, returned as host uint8 with their ground truth."""
    geometry = int(traffic["world_seed"])
    place = world(traffic["world"])
    pose7, centers, around = place.path(traffic, n_frames, geometry)
    bmin, bmax, salt = place.build(around, geometry)
    boxes = World(np.asarray(bmin, np.float32), np.asarray(bmax, np.float32),
                  np.random.default_rng(seed).permutation(np.asarray(salt, np.int32)))
    xn, yn = ray_grid(slam["image_width"], slam["image_height"], slam["fx"], slam["fy"],
                      slam["cx"], slam["cy"], slam["dist_coeffs"])
    xn, yn = torch.from_numpy(xn).to(device), torch.from_numpy(yn).to(device)
    k = min(int(traffic["n_boxes"]), len(boxes.salt))
    tex = float(traffic["tex_scale"])
    out = torch.empty((n_frames,) + tuple(xn.shape), dtype=torch.uint8, device=device)
    # one frame's inputs at fixed shapes: on the card the render is replayed
    # from a CUDA graph, each frame's pose and boxes copied into its inputs
    pose_in = torch.zeros(7, dtype=torch.float32, device=device)
    bmin_in = torch.zeros((k, 3), dtype=torch.float32, device=device)
    bmax_in = torch.zeros((k, 3), dtype=torch.float32, device=device)
    salt_in = torch.zeros(k, dtype=torch.int64, device=device)

    def render():
        img = raycast(pose_in, xn, yn, bmin_in, bmax_in, salt_in, tex)
        return torch.round(img * 255.0).to(torch.uint8)

    def load(i):
        w = select_boxes(boxes, centers[i], k)
        pose_in.copy_(torch.from_numpy(pose7[i]))
        bmin_in.copy_(torch.from_numpy(w.bmin))
        bmax_in.copy_(torch.from_numpy(w.bmax))
        salt_in.copy_(torch.from_numpy(w.salt.astype(np.int64)))

    with torch.no_grad():
        graph = None
        if device.type == "cuda":
            load(0)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                render()                       # the warm-up, outside the capture
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static = render()
        for i in range(n_frames):
            load(i)
            if graph is None:
                out[i] = render()
            else:
                graph.replay()
                out[i] = static
    return Stream(out.cpu().numpy(), pose7, centers)
