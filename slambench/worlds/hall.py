"""``"world": "hall"``: a drone flying the EuRoC proxy's aggressive 6-DoF
circuit of a machine hall, its pillars and crates placed from the seed.

The traffic file's ``loop_frames`` is the circuit's length in frames.  The
proxy's circuit is ``BASE_LAP`` frames; a longer one is that circuit drawn
``loop_frames / BASE_LAP`` times as large, so the drone flies it at the
same speed and climbs, rolls and wobbles at the same rates a frame, in a
hall as much larger, with as many pillars and crates a square metre.
Frozen copy of ``asdslam_torch/io/euroc_proxy.py`` (``mav_trajectory``,
``build_hall``).
"""

from __future__ import annotations

import numpy as np

BASE_LAP = 1200               # the proxy's circuit, in frames
PILLARS_PER_M2 = 60 / 485.6   # the proxy's 60 in its hall's floor


def mav_trajectory(n_frames: int, loop_frames: int):
    """(pose7_cw [n, 7], centers [n, 3]) of the closed aggressive 6-DoF
    circuit of a hall (y down), ``loop_frames`` a lap."""
    s = loop_frames / BASE_LAP
    i = np.arange(n_frames, dtype=np.float64)
    tau = 2.0 * np.pi * i / float(loop_frames)    # the lap's phase
    phi = 2.0 * np.pi * i / float(BASE_LAP)       # the climbs' and rolls' phase
    x = s * (8.0 * np.sin(tau) + 1.8 * np.sin(3.0 * tau))
    z = s * (10.0 - 7.0 * np.cos(tau) - 1.2 * np.cos(2.0 * tau))
    y = -1.6 - 1.6 * np.sin(2.0 * phi) - 0.5 * np.sin(5.0 * phi)
    centers = np.stack([x, y, z], axis=1).astype(np.float32)
    vel = np.gradient(centers, axis=0)
    fwd = vel.copy()
    fwd[:, 1] *= 0.5
    fwd /= np.maximum(np.linalg.norm(fwd, axis=1, keepdims=True), 1e-9)
    roll = 0.18 * np.sin(6.0 * phi) + 0.06 * np.sin(11.0 * phi)
    yaw_wob = 0.12 * np.sin(9.0 * phi)
    pose7 = np.zeros((n_frames, 7), np.float32)
    up = np.array([0.0, -1.0, 0.0])
    for k in range(n_frames):
        zc = fwd[k]
        cw, sw = np.cos(yaw_wob[k]), np.sin(yaw_wob[k])
        zc = cw * zc + sw * np.cross(up, zc) + (1 - cw) * np.dot(up, zc) * up
        zc /= np.linalg.norm(zc)
        xc = np.cross(-up, zc)
        n = np.linalg.norm(xc)
        xc = xc / n if n > 1e-6 else np.array([1.0, 0.0, 0.0])
        yc = np.cross(zc, xc)
        cr, sr = np.cos(roll[k]), np.sin(roll[k])
        xr = cr * xc + sr * yc
        yr = -sr * xc + cr * yc
        R_cw = np.stack([xr, yr, zc], axis=1).T
        pose7[k, :4] = _mat_to_quat(R_cw)
        pose7[k, 4:] = -R_cw @ centers[k]
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


def path(traffic: dict, n_frames: int, seed: int):
    """(pose7_cw, centers) of the first ``n_frames`` frames, and the centres
    the hall is built around: the whole circuit."""
    loop = int(traffic["loop_frames"])
    pose7, centers = mav_trajectory(n_frames, loop)
    return pose7, centers, mav_trajectory(loop, loop)[1]


def build(centers: np.ndarray, seed: int):
    """(bmin [B, 3], bmax [B, 3], salt [B]): floor, ceiling and wall slabs
    around the flight volume, and pillars and crates placed from the seed
    away from the flight path."""
    rng = np.random.default_rng(seed)
    lo = centers.min(axis=0) - np.array([4.0, 3.0, 4.0])
    hi = centers.max(axis=0) + np.array([4.0, 2.0, 4.0])
    floor_y = hi[1] + 1.0
    ceil_y = lo[1] - 0.5
    bmins, bmaxs, salts = [], [], []

    def slab(bmin, bmax, salt):
        bmins.append(bmin)
        bmaxs.append(bmax)
        salts.append(salt)

    T = 0.5
    slab([lo[0], floor_y, lo[2]], [hi[0], floor_y + T, hi[2]], 11)
    slab([lo[0], ceil_y - T, lo[2]], [hi[0], ceil_y, hi[2]], 12)
    slab([lo[0] - T, ceil_y, lo[2]], [lo[0], floor_y, hi[2]], 13)
    slab([hi[0], ceil_y, lo[2]], [hi[0] + T, floor_y, hi[2]], 14)
    slab([lo[0], ceil_y, lo[2] - T], [hi[0], floor_y, lo[2]], 15)
    slab([lo[0], ceil_y, hi[2]], [hi[0], floor_y, hi[2] + T], 16)
    path2d = centers[:, [0, 2]]
    pillars = int(round(PILLARS_PER_M2 * (hi[0] - lo[0]) * (hi[2] - lo[2])))
    placed, tries = 0, 0
    while placed < pillars and tries < 10 * pillars:
        tries += 1
        cx = rng.uniform(lo[0] + 1, hi[0] - 1)
        cz = rng.uniform(lo[2] + 1, hi[2] - 1)
        hw = rng.uniform(0.3, 1.2)
        if np.min(np.linalg.norm(path2d - [cx, cz], axis=1)) < hw + 1.6:
            continue
        if rng.random() < 0.5:
            y0, y1 = ceil_y, floor_y
        else:
            y0, y1 = floor_y - rng.uniform(0.6, 2.5), floor_y
        slab([cx - hw, y0, cz - hw], [cx + hw, y1, cz + hw], 100 + placed)
        placed += 1
    return bmins, bmaxs, salts
