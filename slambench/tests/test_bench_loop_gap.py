"""``loop_gap``, the closure error of a window's loops, on hand-made
trajectories: nought on a closed lap seen under any similarity, whether
every frame or only keyframes hold a centre, the known value on a lap with a
planted endpoint drift, and inf where there is no loop, where a loop's own
keyframe has no centre or where a lap holds fewer than three."""

import math

import numpy as np
import pytest

import cpu_route  # noqa: F401  (puts the harness on the path)
import check
import generator
import reference as ref

def similarity(seed):
    """(s, R, t): a scale, a proper rotation and a shift drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return rng.uniform(0.2, 5.0), q, rng.normal(scale=10.0, size=3)


def lemniscate(n):
    """n + 1 centres of a figure eight in the plane y = 0 that starts and
    ends at its crossing, which is also the centroid of the n + 1 points."""
    tau = 2.0 * np.pi * np.arange(n + 1) / n
    return 4.0 * np.stack([np.sin(tau), np.zeros_like(tau), np.sin(tau) * np.cos(tau)], 1)


def as_dict(c, first=0):
    return {first + i: p for i, p in enumerate(c)}


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_closed_lap_under_a_similarity_reads_nought(seed):
    # the circle's first lap and a bit, from frame 7 to frame 130
    _, g = generator.world("circle").circle_path(140, 0.22, 110)
    g = g.astype(np.float64)
    s, R, t = similarity(seed)
    est = as_dict(s * g @ R.T + t)
    assert ref.loop_gap([(7, 130)], est, g) == pytest.approx(0.0, abs=1e-9)
    # several loops: the largest
    assert ref.loop_gap([(7, 130), (20, 131)], est, g) == pytest.approx(0.0, abs=1e-9)
    # keyframes only: every few frames, and the loop's own two
    sparse = {f: c for f, c in est.items() if f % 4 == 1 or f in (7, 130)}
    assert ref.loop_gap([(7, 130)], sparse, g) == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("n", (60, 400))
def test_planted_endpoint_drift_reads_its_known_value(n):
    """The last frame's centre lifted h out of the lap's plane: the fit's
    cross-covariance is that of the lap alone (the lift meets only frames at
    the centroid), so R is the identity, the scale is var_g / (var_g +
    h^2 (m - 1) / m^2) over m = n + 1 frames, and the gap s h over the
    lap's length; seen under any similarity, the same."""
    g = lemniscate(n)
    h = 0.3
    c = g.copy()
    c[-1, 1] += h
    m = n + 1
    var_g = (g ** 2).sum() / m
    s = var_g / (var_g + h * h * (m - 1) / m ** 2)
    length = np.linalg.norm(np.diff(g, axis=0), axis=1).sum()
    want = s * h / length
    assert ref.loop_gap([(0, n)], as_dict(c), g) == pytest.approx(want, rel=1e-9)
    s0, R0, t0 = similarity(n)
    seen = as_dict(s0 * c @ R0.T + t0)
    assert ref.loop_gap([(0, n)], seen, g) == pytest.approx(want, rel=1e-9)
    # the loop's order in the pair does not matter; a closed loop beside it
    # leaves the largest
    assert ref.loop_gap([(n, 0), (0, n // 2)], seen, g) == pytest.approx(want, rel=1e-9)


def test_no_loop_reads_inf():
    g = lemniscate(50)
    assert ref.loop_gap([], as_dict(g), g) == math.inf


def test_a_missing_pose_reads_inf():
    """A loop whose own keyframe has no pose, or whose lap holds fewer than
    three, reads inf, alone or beside a sound loop."""
    g = lemniscate(50)
    est = as_dict(g)
    for gone in (0, 50):
        holed = {f: c for f, c in est.items() if f != gone}
        assert ref.loop_gap([(0, 50)], holed, g) == math.inf
        assert ref.loop_gap([(0, 50), (10, 40)], holed, g) == math.inf
    two = {0: g[0], 50: g[50]}
    assert ref.loop_gap([(0, 50)], two, g) == math.inf
    # beside a sound lap
    assert ref.loop_gap([(0, 50), (0, 50)], as_dict(g), g) == pytest.approx(0.0, abs=1e-9)
    assert ref.loop_gap([(0, 20), (30, 50)], two | {10: g[10], 20: g[20]}, g) == math.inf
    # a loop whose lap runs past the truth's frames
    assert ref.loop_gap([(0, 60)], as_dict(lemniscate(70)), g) == math.inf


def test_check_reads_poses():
    """``check.loop_gap`` takes a trajectory of T_cw poses: the truth's own
    poses at keyframe-like frames read nought, a lap with its centres
    drifting along the way does not, and a lap of two poses reads inf."""
    pose7, centers = generator.world("circle").circle_path(150, 0.22, 110)
    kfs = [(f, pose7[f]) for f in range(0, 150, 5)]
    assert check.loop_gap([(5, 125)], kfs, pose7) == pytest.approx(0.0, abs=1e-9)
    assert check.loop_gap([(5, 125)], [kfs[1], kfs[25]], pose7) == math.inf
    assert check.loop_gap([(3, 128)], kfs, pose7) == math.inf
    # a drift growing with the frame: each pose's centre moved by f * 2 mm
    # along x (t_cw = -R c, so t moves by -R dc)
    drift = []
    for f, p in kfs:
        q = p.astype(np.float64).copy()
        dc = np.array([0.002 * f, 0.0, 0.0])
        R = ref_rotation(q[:4])
        q[4:] -= R @ dc
        drift.append((f, q))
    assert check.loop_gap([(5, 125)], drift, pose7) > 1e-3


def ref_rotation(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
