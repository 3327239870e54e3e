"""``"world": "circle"``: a camera driving laps of a circle inside a closed
room of textured walls, so that each lap revisits the last and a loop can
close.

The circle is that of ``chip_smoke.py``'s loop phase (and
``tests/test_e2e_loop.py``): ``step_m`` a frame (0.22 m there), a full turn
in ``lap_frames`` frames (110 there), starting at the origin facing +z and
turning about the vertical axis, lap after lap.  The room has that phase's
extents (``ROOM``, its ``LOOP_SCENE``): floor, ceiling and four walls, each
a slab box, so the frozen ray-caster of ``generator.py`` renders it.  Each
step is the same motion as ``asdslam_torch/io/synthetic.py::make_trajectory``
applies (T_cw <- exp(xi) T_cw, xi = (0, turn, 0, 0, 0, -step)), composed
here in float64.

On the ``kitti`` configuration at 1241x376 with 60 warm-up frames, on an
NVIDIA H100, the port closed its first loop at frames 117-140 of this
circle on every seed tried: a keyframe just past the first lap's end onto
one of the lap's first keyframes (frames 13-34).
"""

from __future__ import annotations

import numpy as np

# the room's planes (y down): chip_smoke.py's LOOP_SCENE
ROOM = dict(floor_y=2.0, ceil_y=-3.0, left_x=-8.0, right_x=8.0, back_z=-8.0, front_z=16.0)
WALL_M = 0.5                  # the slabs' thickness, outside the room


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def circle_path(n_frames: int, step_m: float, lap_frames: int):
    """(pose7_cw [n, 7], centers [n, 3]): ``n_frames`` poses of the circle.
    One step is exp(xi) with xi = (omega, upsilon) = ((0, turn, 0),
    (0, 0, -step)), left-multiplied onto T_cw."""
    turn = 2.0 * np.pi / float(lap_frames)
    dR = _rot_y(turn)
    # exp's translation V upsilon for a rotation of angle |turn| about y
    K = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    th = abs(turn)
    V = np.eye(3)
    if th > 1e-12:
        Ku = K * np.sign(turn)
        V = (np.eye(3) + (1.0 - np.cos(th)) / th * Ku
             + (th - np.sin(th)) / th * (Ku @ Ku))
    dt = V @ np.array([0.0, 0.0, -float(step_m)])
    R, t = np.eye(3), np.zeros(3)
    pose7 = np.zeros((n_frames, 7), np.float64)
    centers = np.zeros((n_frames, 3), np.float64)
    for i in range(n_frames):
        pose7[i, :4] = _quat(R)
        pose7[i, 4:] = t
        centers[i] = -R.T @ t
        R, t = dR @ R, dR @ t + dt
    return pose7.astype(np.float32), centers.astype(np.float32)


def _quat(R: np.ndarray) -> np.ndarray:
    """(qw, qx, qy, qz) of a rotation about y (the circle's only axis)."""
    a = np.arctan2(R[0, 2], R[0, 0])
    return np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0])


def path(traffic: dict, n_frames: int, seed: int):
    """(pose7_cw, centers) of the first ``n_frames`` frames, and the centres
    the room is built around (the room does not depend on them)."""
    pose7, centers = circle_path(n_frames, traffic["step_m"], traffic["lap_frames"])
    return pose7, centers, centers


def build(centers: np.ndarray, seed: int):
    """(bmin [6, 3], bmax [6, 3], salt [6]): the floor, the ceiling and the
    four walls as slabs ``WALL_M`` thick just outside ``ROOM``'s planes,
    overlapping at the edges so that no ray leaves the room."""
    r, w = ROOM, WALL_M
    x0, x1 = r["left_x"] - w, r["right_x"] + w
    y0, y1 = r["ceil_y"] - w, r["floor_y"] + w
    z0, z1 = r["back_z"] - w, r["front_z"] + w
    bmins = [[x0, r["floor_y"], z0], [x0, y0, z0],             # floor, ceiling
             [x0, y0, z0], [r["right_x"], y0, z0],             # left, right
             [x0, y0, z0], [x0, y0, r["front_z"]]]             # back, front
    bmaxs = [[x1, y1, z1], [x1, r["ceil_y"], z1],
             [r["left_x"], y1, z1], [x1, y1, z1],
             [x1, y1, r["back_z"]], [x1, y1, z1]]
    return bmins, bmaxs, [1, 2, 3, 4, 5, 6]
