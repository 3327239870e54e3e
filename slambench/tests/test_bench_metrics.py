"""The metric arithmetic on hand-made spans and profiles."""

import numpy as np
import pytest

import cpu_route  # noqa: F401
import roofline
import run

PEAKS = roofline.CARD_PEAKS["NVIDIA H100 80GB HBM3"]


def base(**kw):
    r = {"frames": 0, "window_s": 10.0, "calls_s": [], "spans": {}, "setup_s": 12.5,
         "n_features": 2000, "peaks": PEAKS, "profile": None}
    r.update(kw)
    return r


def test_fps_and_setup():
    assert run.reader("fps")(base(frames=75, window_s=10.0)) == 7.5
    assert run.reader("fps")(base()) is None
    assert run.reader("setup_s")(base()) == 12.5


def test_p95_over_all_calls_not_chunks():
    # 180 fast calls, then 20 slow ones: the p95 of all 200 calls is a slow
    # call's; a mean of ten chunks' own p95 would give another number
    calls = [0.05] * 180 + [0.5] * 20
    got = run.reader("frame_ms_p95")(base(calls_s=calls))
    assert got == pytest.approx(500.0)
    chunked = np.mean([np.percentile(np.asarray(calls[i:i + 20]) * 1e3, 95)
                       for i in range(0, 200, 20)])
    assert abs(got - chunked) > 1.0
    assert run.reader("frame_ms_p95")(base()) is None


def test_span_readers():
    spans = {
        "frame/fused_track/kernel": {"count": 30, "total_s": 1.5},
        "fused_track/kernel": {"count": 10, "total_s": 0.5},
        "frame/fused_track/join_mapping": {"count": 3, "total_s": 0.6},
        "frame/fused_track/create_kf/join_mapping": {"count": 1, "total_s": 0.4},
        "mapping": {"count": 4, "total_s": 1.0},
        "loop_closing": {"count": 4, "total_s": 0.2},
        "mapping/fuse": {"count": 4, "total_s": 0.3},
    }
    r = base(frames=50, spans=spans)
    assert run.reader("fused_fetch_ms")(r) == pytest.approx(50.0)
    assert run.reader("join_wait_ms")(r) == pytest.approx(1000.0 / 50)
    assert run.reader("mapping_ms")(r) == pytest.approx(250.0)
    assert run.reader("loop_detect_ms")(r) == pytest.approx(50.0)
    empty = base(frames=50)
    for name in ("fused_fetch_ms", "mapping_ms", "loop_detect_ms"):
        assert run.reader(name)(empty) is None


def test_profile_readers():
    kernels = [("search_kernel<128>", 0.0, 40.0), ("order_kernel", 100.0, 120.0),
               ("gather_kernel", 130.0, 140.0), ("elementwise", 30.0, 90.0)]
    prof = {"kernels": kernels, "busy_s": 140e-6, "wall_s": 200e-6,
            "k1_launches": [(8192, 2000, 128), (2000, 2000, 128)]}
    r = base(profile=prof)
    least = (roofline.matcher_bytes(8192, 2000, 128)
             + roofline.matcher_bytes(2000, 2000, 128)) / PEAKS["bytes"]
    assert run.reader("k1_roofline")(r) == pytest.approx(100 * least / 70e-6)
    assert run.reader("idle_share")(r) == pytest.approx(30.0)
    assert run.reader("k1_roofline")(base(profile=dict(prof, k1_launches=[]))) is None
    assert run.reader("k1_roofline")(base()) is None
    assert run.reader("idle_share")(base()) is None


def test_step_mfu():
    r = base(frames=70, window_s=10.0)
    want = 100 * 70 * 2000 * 78184448 / (10.0 * 989e12)
    assert run.reader("step_mfu")(r) == pytest.approx(want)
    assert run.reader("step_mfu")(base(frames=70, peaks=None)) is None


def test_busy_union_and_gaps():
    class Ev:
        def __init__(self, name, a, b, dev):
            from torch.autograd import DeviceType
            self.name = name
            self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
            self.time_range = type("R", (), {"start": a, "end": b})()

    s = run.Slice.__new__(run.Slice)
    s.wall_s, s.launches = 1e-3, []
    s.prof = type("P", (), {"events": lambda self: [
        Ev("k1", 0, 100, True), Ev("k2", 50, 150, True), Ev("k3", 400, 500, True),
        Ev("k4", 520, 600, True), Ev("span:join_mapping", 140, 450, False),
        Ev("aten::copy_", 160, 170, False)]})()
    out = s.summary()
    assert out["busy_s"] == pytest.approx(330e-6)
    assert out["idle_gaps"][0] == ["span:join_mapping", pytest.approx(250e-6)]
    assert out["device_ops"][0][0] in ("k1", "k2", "k3")
