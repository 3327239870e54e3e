"""EuRoC-analog proxy sequence: aggressive 6-DoF MAV motion through an
indoor hall, rendered at the real EuRoC cam0 resolution (752x480) through the
real EuRoC radtan intrinsics (fx=458.654 fy=457.296 cx=367.215 cy=248.375,
k1=-0.2834 k2=0.0740 p1=1.94e-4 p2=1.76e-5).

Port of ``asdslam_tpu/io/euroc_proxy.py``.  The path is synthesized to match
the machine-hall sequences' character: a closed, smooth 6-DoF sweep of a
hall at MAV speeds (~0.8 m/s at 20 Hz) with yaw/pitch/roll oscillation,
returning to the start region so that a loop closure is detectable.  Each
pixel's ray inverts the radtan model, so the rendered frames carry the real
lens distortion and the SLAM side must undistort to track.

The trajectory, the hall and the ray grid are numpy and copied; frames are
ray-cast in torch (``kitti_proxy.raycast_grid``) on the sequence's device,
where the ray grid is uploaded once.
"""

from __future__ import annotations

import numpy as np
import torch

from asdslam_torch.io.kitti_proxy import World, raycast_grid, select_boxes

# real EuRoC cam0 (MH_EUROC/EuRoC_config.txt line 1)
EUROC_FX, EUROC_FY = 458.654, 457.296
EUROC_CX, EUROC_CY = 367.215, 248.375
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
EUROC_W, EUROC_H = 752, 480


# --------------------------------------------------------------------------- #
# Trajectory synthesis (6-DoF, closed loop)
# --------------------------------------------------------------------------- #
def mav_trajectory(n_frames: int = 1300, seed: int = 5, loop_frames: int = 1200):
    """Closed aggressive 6-DoF path through the hall.  Returns
    (pose7_cw [N, 7], centers [N, 3]); y is DOWN (camera convention).
    ``loop_frames`` frames complete one circuit (per-frame motion density is
    independent of ``n_frames``); the default n_frames > loop_frames
    revisits the start region so a loop closure is detectable.  Speeds
    ~0.04-0.07 m/frame, rotation ~0.01-0.02 rad/frame with continuous
    roll/pitch oscillation."""
    t = np.arange(n_frames, dtype=np.float64) / float(loop_frames)
    tau = 2.0 * np.pi * t
    # closed Lissajous-style sweep with harmonics for hall coverage
    x = 8.0 * np.sin(tau) + 1.8 * np.sin(3.0 * tau)
    z = 10.0 - 7.0 * np.cos(tau) - 1.2 * np.cos(2.0 * tau)
    y = -1.6 - 1.6 * np.sin(2.0 * tau) - 0.5 * np.sin(5.0 * tau)
    centers = np.stack([x, y, z], axis=1).astype(np.float32)

    # orientation: look along the horizontal velocity, plus pitch toward the
    # vertical velocity and an oscillating roll (MAV banking)
    vel = np.gradient(centers, axis=0)
    fwd = vel.copy()
    fwd[:, 1] *= 0.5                       # partial pitch-follow
    fwd /= np.maximum(np.linalg.norm(fwd, axis=1, keepdims=True), 1e-9)
    roll = 0.18 * np.sin(6.0 * tau) + 0.06 * np.sin(11.0 * tau)
    yaw_wob = 0.12 * np.sin(9.0 * tau)

    pose7 = np.zeros((n_frames, 7), np.float32)
    up_world = np.array([0.0, -1.0, 0.0])  # y down: world "up" is -y
    for i in range(n_frames):
        zc = fwd[i]
        # yaw wobble about world up
        cw, sw = np.cos(yaw_wob[i]), np.sin(yaw_wob[i])
        u = up_world
        zc = (cw * zc + sw * np.cross(u, zc) + (1 - cw) * np.dot(u, zc) * u)
        zc /= np.linalg.norm(zc)
        xc = np.cross(-up_world, zc)       # right = down x forward
        n = np.linalg.norm(xc)
        xc = xc / n if n > 1e-6 else np.array([1.0, 0.0, 0.0])
        yc = np.cross(zc, xc)
        # roll about the optical axis
        cr, sr = np.cos(roll[i]), np.sin(roll[i])
        xr = cr * xc + sr * yc
        yr = -sr * xc + cr * yc
        R_wc = np.stack([xr, yr, zc], axis=1)   # columns = camera axes
        R_cw = R_wc.T
        t_cw = -R_cw @ centers[i]
        pose7[i, :4] = _mat_to_quat(R_cw)
        pose7[i, 4:] = t_cw
    return pose7, centers


def _mat_to_quat(R):
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                          (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
        elif i == 1:
            s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
            q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                          0.25 * s, (R[1, 2] + R[2, 1]) / s])
        else:
            s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
            q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                          (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    return (q / np.linalg.norm(q)).astype(np.float32)


# --------------------------------------------------------------------------- #
# Hall world
# --------------------------------------------------------------------------- #
def build_hall(centers: np.ndarray, seed: int = 5) -> World:
    """Machine-hall box world: floor/ceiling/wall slabs enclosing the flight
    volume (each a thin box seen from outside — the ray-caster hits entry
    faces) plus pillars and crates, culled away from the flight path."""
    rng = np.random.default_rng(seed)
    lo = centers.min(axis=0) - np.array([4.0, 3.0, 4.0])
    hi = centers.max(axis=0) + np.array([4.0, 2.0, 4.0])
    # y down: floor at hi[1] + margin, ceiling at lo[1]
    floor_y = hi[1] + 1.0
    ceil_y = lo[1] - 0.5
    bmins, bmaxs, salts = [], [], []

    def slab(bmin, bmax, salt):
        bmins.append(bmin)
        bmaxs.append(bmax)
        salts.append(salt)

    T = 0.5  # slab thickness
    slab([lo[0], floor_y, lo[2]], [hi[0], floor_y + T, hi[2]], 11)   # floor
    slab([lo[0], ceil_y - T, lo[2]], [hi[0], ceil_y, hi[2]], 12)     # ceiling
    slab([lo[0] - T, ceil_y, lo[2]], [lo[0], floor_y, hi[2]], 13)    # x- wall
    slab([hi[0], ceil_y, lo[2]], [hi[0] + T, floor_y, hi[2]], 14)    # x+ wall
    slab([lo[0], ceil_y, lo[2] - T], [hi[0], floor_y, lo[2]], 15)    # z- wall
    slab([lo[0], ceil_y, hi[2]], [hi[0], floor_y, hi[2] + T], 16)    # z+ wall

    path2d = centers[:, [0, 2]]
    n_struct, placed, tries = 60, 0, 0
    while placed < n_struct and tries < 600:
        tries += 1
        cx = rng.uniform(lo[0] + 1, hi[0] - 1)
        cz = rng.uniform(lo[2] + 1, hi[2] - 1)
        hw = rng.uniform(0.3, 1.2)
        d = np.min(np.linalg.norm(path2d - [cx, cz], axis=1))
        if d < hw + 1.6:
            continue
        if rng.random() < 0.5:  # pillar: floor to ceiling
            y0, y1 = ceil_y, floor_y
        else:                   # crate on the floor
            h = rng.uniform(0.6, 2.5)
            y0, y1 = floor_y - h, floor_y
        slab([cx - hw, y0, cz - hw], [cx + hw, y1, cz + hw], 100 + placed)
        placed += 1
    return World(np.asarray(bmins, np.float32), np.asarray(bmaxs, np.float32),
                 np.asarray(salts, np.int32))


# --------------------------------------------------------------------------- #
# Distorted-camera ray grid
# --------------------------------------------------------------------------- #
def distorted_ray_grid(width: int, height: int, fx, fy, cx, cy, dist, iters: int = 10):
    """Per-pixel true ray directions for a radtan camera: invert the
    distortion model at every pixel (fixed-point, the same scheme as
    camera.undistort_normalized) so that rendering through this grid
    produces a genuinely distorted image."""
    k1, k2, p1, p2 = dist
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x.astype(np.float32), y.astype(np.float32)


# --------------------------------------------------------------------------- #
# Sequence facade
# --------------------------------------------------------------------------- #
class EurocProxySequence:
    """seq[i] -> (timestamp, [H, W] float image in [0, 1] on ``device``) at
    752x480 with the real EuRoC cam0 radtan distortion baked into the
    rendering."""

    def __init__(self, n_frames: int = 1300, scale: float = 1.0, n_boxes: int = 96,
                 seed: int = 5, fps: float = 20.0, loop_frames: int = 1200, device="cuda"):
        self.device = torch.device(device)
        self.width = int(round(EUROC_W * scale))
        self.height = int(round(EUROC_H * scale))
        self.fx = EUROC_FX * scale
        self.fy = EUROC_FY * scale
        self.cx = EUROC_CX * scale
        self.cy = EUROC_CY * scale
        self.dist = EUROC_DIST
        self.gt_pose7, self.centers = mav_trajectory(n_frames, seed=seed,
                                                     loop_frames=loop_frames)
        self.timestamps = np.arange(n_frames) / fps
        # the hall is always built around the full circuit (a short tracked
        # prefix must still fly inside the complete hall)
        _, full_centers = mav_trajectory(loop_frames, seed=seed, loop_frames=loop_frames)
        self.world = build_hall(full_centers, seed=seed)
        self.n_boxes = min(n_boxes, len(self.world.salt))
        xn, yn = distorted_ray_grid(self.width, self.height, self.fx, self.fy,
                                    self.cx, self.cy, self.dist)
        self._xn = torch.from_numpy(xn).to(self.device)
        self._yn = torch.from_numpy(yn).to(self.device)

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        w = select_boxes(self.world, self.centers[i], self.n_boxes)
        img = raycast_grid(torch.from_numpy(self.gt_pose7[i]).to(self.device),
                           self._xn, self._yn, w.bmin, w.bmax, w.salt, tex_scale=0.22)
        return float(self.timestamps[i]), img

    def config(self, base=None, **kw):
        from asdslam_torch.config import SlamConfig
        base = base or SlamConfig()
        return base.replace(image_width=self.width, image_height=self.height,
                            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
                            dist_coeffs=self.dist, **kw)
