"""``"world": "street"``: a car on a street of textured boxes (road slabs
under the path, buildings on both sides), the KITTI proxy's world.

The path moves ``step_m`` a frame; its yaw rate is a chain of segments whose
lengths and rates are the traffic file's ``segments`` list, in an order and
with signs drawn from the seed, each sign flipped where the heading would
pass ``heading_max_rad`` from the start.  Frozen copy of
``asdslam_torch/io/kitti_proxy.py::build_world`` and chip_smoke 12b's path.
"""

from __future__ import annotations

import numpy as np

CAMERA_HEIGHT = 1.65          # KITTI's gray camera above the road, metres
# the street runs on this many frames past the last one, so the view ahead
# is built
AHEAD_FRAMES = 80


def street_path(n_frames: int, seed: int, step_m: float, segments, heading_max_rad: float):
    """(pose7_cw [n, 7], centers [n, 3]) of a car on a flat street: the
    camera's forward axis in the world is (sin a, 0, cos a) at heading a.
    ``segments`` is a list of [frames, yaw rate a frame]; the seed orders
    them and draws each sign, and the chain repeats until n frames."""
    rng = np.random.default_rng(seed)
    segs = [(int(n), abs(float(r))) for n, r in segments]
    rates = []
    heading = 0.0
    while len(rates) < n_frames:
        for k in rng.permutation(len(segs)):
            n, r = segs[k]
            r = r if rng.random() < 0.5 else -r
            if abs(heading + n * r) > heading_max_rad:
                r = -r
            rates.extend([r] * n)
            heading += n * r
    a = np.concatenate([[0.0], np.cumsum(np.asarray(rates[:n_frames - 1], np.float64))])
    x = np.concatenate([[0.0], np.cumsum(step_m * np.sin(a[1:]))])
    z = np.concatenate([[0.0], np.cumsum(step_m * np.cos(a[1:]))])
    centers = np.stack([x, np.zeros_like(x), z], axis=1)
    # T_wc is a rotation by a about y; T_cw = (R^T, -R^T c)
    c, s = np.cos(a), np.sin(a)
    pose7 = np.zeros((n_frames, 7), np.float64)
    pose7[:, 0] = np.cos(a / 2)
    pose7[:, 2] = -np.sin(a / 2)
    # R_cw = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    pose7[:, 4] = -(c * x - s * z)
    pose7[:, 5] = 0.0
    pose7[:, 6] = -(s * x + c * z)
    return pose7.astype(np.float32), centers.astype(np.float32)


def path(traffic: dict, n_frames: int, seed: int):
    """(pose7_cw, centers) of the first ``n_frames`` frames, and the centres
    the street is built around."""
    pose7, centers = street_path(n_frames + AHEAD_FRAMES, seed, traffic["step_m"],
                                 traffic["segments"], traffic["heading_max_rad"])
    return pose7[:n_frames], centers[:n_frames], centers


def build(centers: np.ndarray, seed: int, road_spacing: float = 4.0,
          building_spacing: float = 6.0, lateral_min: float = 7.0,
          lateral_max: float = 15.0):
    """(bmin [B, 3], bmax [B, 3], salt [B]): road slabs under the path and
    buildings on both sides of it, culled where they would touch the path's
    corridor."""
    rng = np.random.default_rng(seed)
    seg = np.linalg.norm(np.diff(centers, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(s[-1])

    def sample(spacing):
        si = np.arange(0.0, total, spacing)
        p = np.stack([np.interp(si, s, centers[:, k]) for k in range(3)], 1)
        tang = np.gradient(p, axis=0)
        tang[:, 1] = 0.0
        tang = tang / np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-6)
        lat = np.stack([-tang[:, 2], np.zeros(len(p)), tang[:, 0]], 1)
        return p, lat

    bmins, bmaxs, salts = [], [], []
    road_p, _ = sample(road_spacing)
    ground_y = road_p[:, 1] + CAMERA_HEIGHT
    half = road_spacing * 1.6
    for i, p in enumerate(road_p):
        bmins.append([p[0] - half, ground_y[i], p[2] - half])
        bmaxs.append([p[0] + half, ground_y[i] + 0.3, p[2] + half])
        salts.append(1000 + i)
    b_p, b_lat = sample(building_spacing)
    path2d = centers[:, [0, 2]]
    for i, p in enumerate(b_p):
        gy = p[1] + CAMERA_HEIGHT
        for side in (-1.0, 1.0):
            off = rng.uniform(lateral_min, lateral_max)
            c = p + side * off * b_lat[i]
            hw = rng.uniform(2.0, 5.0)
            h = rng.uniform(4.0, 13.0)
            if np.min(np.linalg.norm(path2d - c[[0, 2]], axis=1)) < hw + 4.5:
                continue
            bmins.append([c[0] - hw, gy - h, c[2] - hw])
            bmaxs.append([c[0] + hw, gy + 1.0, c[2] + hw])
            salts.append(i * 2 + (side > 0))
    return bmins, bmaxs, salts
