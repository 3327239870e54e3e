"""The arithmetic of the step's stage metrics and of ``graph_build_ms`` on
hand-made spans, and what they read from a program that records neither
(the parent of the stage clock): nothing."""

import pytest

import cpu_route  # noqa: F401
import roofline
import run

PEAKS = roofline.CARD_PEAKS["NVIDIA H100 80GB HBM3"]
STAGES = ("step_dev_ms", "detect_dev_ms", "describe_dev_ms", "search_dev_ms", "pose_ba_dev_ms")
NEW = STAGES + ("asdnet_mfu", "graph_build_ms")


def base(**kw):
    r = {"frames": 0, "window_s": 10.0, "calls_s": [], "spans": {}, "setup_s": 12.5,
         "n_features": 2000, "peaks": PEAKS, "profile": None}
    r.update(kw)
    return r


def stage_spans(n=40):
    """n committed steps of 70 ms: detect 9, describe 4, search 12, pose BA 40."""
    return {"device/step": {"count": n, "total_s": 0.070 * n},
            "device/step/detect": {"count": n, "total_s": 0.009 * n},
            "device/step/describe": {"count": n, "total_s": 0.004 * n},
            "device/step/search": {"count": n, "total_s": 0.012 * n},
            "device/step/pose_ba": {"count": n, "total_s": 0.040 * n},
            "frame/fused_track/kernel": {"count": n, "total_s": 0.069 * n}}


def test_stage_readers_are_means_of_their_spans():
    r = base(frames=50, spans=stage_spans())
    got = {name: run.reader(name)(r) for name in STAGES}
    assert got == pytest.approx({"step_dev_ms": 70.0, "detect_dev_ms": 9.0,
                                 "describe_dev_ms": 4.0, "search_dev_ms": 12.0,
                                 "pose_ba_dev_ms": 40.0})
    assert sum(got[k] for k in STAGES[1:]) <= got["step_dev_ms"]


def test_asdnet_mfu_over_the_describe_stage():
    r = base(frames=50, spans=stage_spans(40))
    flops = 78_184_448 * 2000 * 40
    want = 100.0 * flops / (0.004 * 40 * 989e12)
    assert run.reader("asdnet_mfu")(r) == pytest.approx(want)
    assert 0 < want < 100
    assert run.reader("asdnet_mfu")(base(frames=50, spans=stage_spans(), peaks=None)) is None


def test_graph_build_ms_counts_each_build_once():
    spans = dict(stage_spans())
    spans.update({
        "mapping/local_ba/warm-up:local_ba": {"count": 2, "total_s": 0.3},
        "mapping/local_ba/capture:local_ba": {"count": 1, "total_s": 0.5},
        "frame/fused_track/dispatch/capture:track_step": {"count": 1, "total_s": 1.0},
        # a build inside another build is part of it
        "frame/fused_track/dispatch/warm-up:track_step": {"count": 1, "total_s": 0.4},
        "frame/fused_track/dispatch/warm-up:track_step/warm-up:extract": {"count": 1,
                                                                           "total_s": 0.1},
        "mapping/local_ba": {"count": 5, "total_s": 2.0},
    })
    r = base(frames=100, spans=spans)
    assert run.reader("graph_build_ms")(r) == pytest.approx((0.3 + 0.5 + 1.0 + 0.4) / 100 * 1e3)
    # the stage clock without a build in the window: no build time
    assert run.reader("graph_build_ms")(base(frames=100, spans=stage_spans())) == 0.0


def test_a_program_without_the_clock_gives_nothing_to_read():
    """The spans of a program without the stage clock (the harness's own
    spans only): every new metric is left out of the line."""
    spans = {"frame/fused_track/kernel": {"count": 30, "total_s": 1.5},
             "mapping": {"count": 4, "total_s": 1.0},
             "mapping/local_ba": {"count": 4, "total_s": 0.6}}
    r = base(frames=50, spans=spans)
    for name in NEW:
        assert run.reader(name)(r) is None, name
    for name in NEW:
        assert run.reader(name)(base()) is None, name
