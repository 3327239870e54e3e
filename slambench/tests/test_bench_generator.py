"""Each traffic's generator repeats from its seed and differs across seeds
(a small camera on the CPU)."""

import numpy as np
import pytest
import torch

import cpu_route  # noqa: F401  (puts the harness on the path)
import generator
import run

TRAFFICS = ("cruise", "mav")


def stream(traffic, seed, n=6):
    t = run.load_json("slambench", "traffic", traffic + ".json")
    cfg = {"cruise": "kitti", "mav": "euroc"}[traffic]
    s = run.load_json("slambench", "configs", cfg + ".json")["slam"]
    k = 0.1
    cam = dict(s, image_width=int(s["image_width"] * k), image_height=int(s["image_height"] * k),
               fx=s["fx"] * k, fy=s["fy"] * k, cx=s["cx"] * k, cy=s["cy"] * k)
    torch.set_num_threads(1)
    return generator.make_stream(t, cam, n, seed, torch.device("cpu"))


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_stream_repeats_from_its_seed(traffic):
    a, b = stream(traffic, 2 ** 31 + 5), stream(traffic, 2 ** 31 + 5)
    assert a.frames.dtype == np.uint8 and a.frames.shape[0] == 6
    assert np.array_equal(a.frames, b.frames)
    assert np.array_equal(a.pose7, b.pose7)


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_stream_differs_across_seeds(traffic):
    a, b = stream(traffic, 3), stream(traffic, 4)
    assert not np.array_equal(a.frames, b.frames)


def test_street_path_keeps_its_segments_and_heading():
    t = run.load_json("slambench", "traffic", "cruise.json")
    street = generator.world("street")
    n = 900
    for seed in (1, 2, 3):
        pose7, centers = street.street_path(n, seed, t["step_m"], t["segments"],
                                               t["heading_max_rad"])
        step = np.linalg.norm(np.diff(centers, axis=0), axis=1)
        assert np.allclose(step, t["step_m"], atol=1e-4)
        heading = 2 * np.arctan2(-pose7[:, 2], pose7[:, 0])
        assert np.abs(heading).max() <= t["heading_max_rad"] + 1e-5
        assert np.abs(np.diff(heading)).max() <= max(abs(r) for _, r in t["segments"]) + 1e-5
    a = street.street_path(n, 1, t["step_m"], t["segments"], t["heading_max_rad"])[1]
    b = street.street_path(n, 2, t["step_m"], t["segments"], t["heading_max_rad"])[1]
    assert not np.allclose(a, b)
    # the same turning in another order: equal total absolute yaw per lap
    lap = sum(int(m) for m, _ in t["segments"])

    def turn(seed):
        p = street.street_path(lap + 1, seed, t["step_m"], t["segments"],
                                  t["heading_max_rad"])[0]
        h = 2 * np.arctan2(-p[:, 2], p[:, 0])
        return np.abs(np.diff(h)).sum()

    assert abs(turn(1) - turn(2)) < 1e-3


def test_ground_truth_poses_match_centres():
    import reference
    for traffic in TRAFFICS:
        s = stream(traffic, 9, n=4)
        assert np.allclose(reference.centres(s.pose7), s.centers, atol=1e-4)


def test_hall_circuit_keeps_the_proxy_s_rates_and_does_not_revisit():
    """The longer circuit flies at the proxy's speed and climbs and rolls at
    its rates a frame; the frames a run renders at four times the frame
    rates measured stay clear of the start."""
    t = run.load_json("slambench", "traffic", "mav.json")
    hall = generator.world("hall")
    n = int(t["warmup_frames"]) + 45 * int(t["max_fps"])
    assert n < int(t["loop_frames"])
    p_long, c_long = hall.mav_trajectory(n, int(t["loop_frames"]))
    p_base, c_base = hall.mav_trajectory(hall.BASE_LAP, hall.BASE_LAP)
    speed = lambda c: np.linalg.norm(np.diff(c, axis=0), axis=1)  # noqa: E731
    assert abs(speed(c_long).mean() / speed(c_base).mean() - 1) < 0.05
    m = min(n, hall.BASE_LAP)
    assert np.allclose(c_long[:m, 1], c_base[:m, 1], atol=1e-5)
    away = np.linalg.norm(c_long[:, [0, 2]] - c_long[0, [0, 2]], axis=1)
    assert away[n // 2:].min() > 10.0
    bmin, bmax, salt = hall.build(hall.path(t, n, 5)[2], 5)
    assert len(salt) <= int(t["n_boxes"])     # every box of the hall is rendered
