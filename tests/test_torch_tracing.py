"""The port's tracing (``asdslam_torch/utils/tracing.py``) on the CPU: the
Tracer's spans from another clock (``Tracer.add``) and from code that does
not hold the tracer (the active tracer, per thread), the stage clock, the
fused tracking step's stamps and the ``device/step`` spans a System records
from them, and the graph builds as spans through ``utils/graphs.py``'s CPU
fakes.  The clock against the card's profiler trace is
tests/test_torch_tracing_card.py.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend import track_step as tts
from asdslam_torch.frontend import tracking as ttracking
from asdslam_torch.io import synthetic
from asdslam_torch.models import patch_descriptor
from asdslam_torch.parallel import multi_seq as tmulti
from asdslam_torch.system import System
from asdslam_torch.utils import graphs, tracing
from asdslam_torch.utils.tracing import Tracer, stage, stage_clock

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_graphs import card  # noqa: E402,F401  (the CPU as the card)
from test_torch_parallel import _tiny_dp_case  # noqa: E402

STAGE_SPANS = ("device/step", "device/step/detect", "device/step/describe",
               "device/step/search", "device/step/pose_ba")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_case():
    return _tiny_dp_case("cpu")


def _leaves(x):
    """The tensors of nested tuples (a None field is none)."""
    return [t for t in torch.utils._pytree.tree_leaves(tuple(x)) if t is not None]


def _fields(res):
    """A step result's tensors without its stamps."""
    return _leaves(res._replace(stamps=None))


# --------------------------------------------------------------------------- #
# The Tracer
# --------------------------------------------------------------------------- #
def test_add_records_a_top_level_span():
    tracer = Tracer()
    with tracer.span("frame"):
        tracer.add("device/step", 0.5)
        tracer.add("device/step", 0.25)
    assert tracer.spans["device/step"].count == 2
    assert tracer.spans["device/step"].total == 0.75
    assert "frame/device/step" not in tracer.spans and tracer.spans["frame"].count == 1
    off = Tracer(enabled=False)
    off.add("device/step", 1.0)
    assert not off.spans


def test_active_tracer_nests_per_thread():
    """Each thread's active tracer is the one whose span is innermost open
    there; a span of the active tracer nests under that thread's stack."""
    a, b = Tracer(), Tracer()
    opened, release = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with b.span("mapping"):
            seen["worker"] = tracing.active()
            with tracing.active_span("capture:local_ba"):
                opened.set()
                release.wait(10)
        seen["worker_after"] = tracing.active()

    assert tracing.active() is None
    with a.span("frame"):
        t = threading.Thread(target=worker)
        t.start()
        assert opened.wait(10)
        assert tracing.active() is a  # the worker's span is not this thread's
        with b.span("inner"):
            assert tracing.active() is b
        assert tracing.active() is a
        with tracing.active_span("warm-up:track_step"):
            pass
        release.set()
        t.join(10)
    assert not t.is_alive()
    assert tracing.active() is None
    assert seen == {"worker": b, "worker_after": None}
    assert set(a.spans) == {"frame", "frame/warm-up:track_step"}
    assert set(b.spans) == {"mapping", "mapping/capture:local_ba", "inner"}  # stacks per tracer
    with tracing.active_span("nothing"):  # no active tracer: nothing recorded
        pass
    assert Tracer(enabled=False).span("x") is not None and tracing.active() is None


# --------------------------------------------------------------------------- #
# The stage clock
# --------------------------------------------------------------------------- #
def test_stage_clock_on_the_cpu():
    stage("start")  # no clock open: nothing
    names = ("start", "a", "b", "end")
    with stage_clock(names, "cpu") as clock:
        for name in names:
            stage(name)
    s = clock.stamps.tolist()
    assert clock.done == 4 and s == sorted(s) and s[0] > 0
    for wrong in (("start", "b"), ("start", "a", "b", "end", "end")):
        with pytest.raises(RuntimeError, match="out of order"):
            with stage_clock(names, "cpu"):
                for name in wrong:
                    stage(name)
    with pytest.raises(RuntimeError, match="closed after"):
        with stage_clock(names, "cpu"):
            stage("start")
    assert tracing.clock_open() is None
    # under a torch.func transform nothing is stamped
    with stage_clock(("start",), "cpu") as clock:
        torch.func.vmap(lambda x: (stage("start"), x * 2)[1])(torch.ones(3))
        assert clock.done == 0
        stage("start")


def test_stamped_step_equals_the_plain_step(tiny_case):
    """Stamps on: the step's outputs are the plain step's bit for bit, the
    stamps rise through ``STAGES``, and the one fetch carries them."""
    cfg, K, extract, imgs, state = tiny_case
    step = tts.make_track_step(cfg, K, extract, device="cpu")
    args = (imgs[0],) + tuple(tmulti._take(x, 0, "cpu") for x in state)
    feat_p, res_p = step(*args)
    feat_s, res_s = step(*args, stamps=True)
    assert res_p.stamps is None and res_s.stamps.shape == (len(tts.STAGES),)
    for x, y in zip(_leaves(feat_s) + _fields(res_s), _leaves(feat_p) + _fields(res_p)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    s = res_s.stamps.tolist()
    assert s == sorted(s) and s[0] < s[-1]
    plain, stamped = ttracking._fetch_small(res_p), ttracking._fetch_small(res_s)
    assert plain[6] is None and stamped[6].tolist() == s
    for x, y in zip(plain[:6], stamped[:6]):
        assert np.array_equal(x, y)
    spans = tts.stage_spans(stamped[6])
    assert set(spans) == set(STAGE_SPANS) and min(spans.values()) >= 0
    assert sum(spans[k] for k in STAGE_SPANS[1:]) <= spans["device/step"]


def test_batched_step_takes_no_stamps(tiny_case):
    """The vmapped step stamps nothing, even inside an open clock, and each
    sequence's result is the single step's, stamped or not."""
    cfg, K, extract, imgs, state = tiny_case
    batched = tts.make_batched_track_step(cfg, K, extract, device="cpu")
    with stage_clock(("start",), "cpu") as clock:
        feats, res = batched(imgs, *state)
        assert clock.done == 0
        stage("start")
    assert res.stamps is None
    single = tts.make_track_step(cfg, K, extract, device="cpu")
    b = 1
    f1, r1 = single(imgs[b], *(tmulti._take(x, b, "cpu") for x in state), stamps=True)
    got = _leaves(tmulti._take(feats, b, "cpu")) + _fields(tmulti._take(res, b, "cpu"))
    want = _leaves(f1) + _fields(r1)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_system_records_stage_spans_once_a_committed_step(monkeypatch):
    """A pipelined System on the CPU: each committed fused step adds each of
    the five ``device/step`` spans once, the four stages within the step."""
    cfg = SlamConfig(n_features=300, n_levels=4, image_width=320, image_height=240,
                     fx=260.0, fy=260.0, cx=160.0, cy=120.0, min_match_count=60,
                     local_ba_max_points=2048, local_ba_max_obs=8192, max_keyframes=64,
                     max_map_points=16384, pose_opt_iters=3, pipelined_tracking=True,
                     async_mapping=True)
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, _ = synthetic.render_sequence(K, 9, cfg.image_height, cfg.image_width,
                                          step=0.25, turn=0.004, device="cpu")
    frames = (frames * 255.0).clamp(0, 255).to(torch.uint8).numpy()
    committed = []
    commit, fused = ttracking.Tracker._commit_fused, ttracking.Tracker._try_fused

    def counted_commit(self, *a):
        ok = commit(self, *a)
        committed.append(ok)
        return ok

    def counted_fused(self, *a):
        feat, ok = fused(self, *a)
        committed.append(ok)
        return feat, ok

    monkeypatch.setattr(ttracking.Tracker, "_commit_fused", counted_commit)
    monkeypatch.setattr(ttracking.Tracker, "_try_fused", counted_fused)
    system = System(cfg, descriptor_fn=patch_descriptor.apply, device="cpu")
    for i in range(frames.shape[0]):
        system.track_monocular(frames[i], i)
    system.finish()
    spans = system.tracer.spans
    n = sum(committed)
    assert n >= 3
    assert all(spans[k].count == n for k in STAGE_SPANS)
    assert all(spans[k].t_min >= 0 for k in STAGE_SPANS)
    assert sum(spans[k].total for k in STAGE_SPANS[1:]) <= spans["device/step"].total
    assert not any(k.startswith("device/") and k not in STAGE_SPANS for k in spans)


# --------------------------------------------------------------------------- #
# Graph builds as spans
# --------------------------------------------------------------------------- #
def test_graph_builds_are_spans(card):
    """A warm-up and a capture are spans of the active tracer, nested under
    the span that paid for them; with no active tracer nothing is
    recorded."""
    tracer = Tracer()
    c = graphs.captured(lambda x: x + 1, "inc")
    x = torch.arange(3.0)
    with tracer.span("mapping"), tracer.span("local_ba"):
        for _ in range(3):
            assert torch.equal(c(x), x + 1)
    assert (card["warm"], card["capture"]) == (1, 1)
    assert tracer.spans["mapping/local_ba/warm-up:inc"].count == 1
    assert tracer.spans["mapping/local_ba/capture:inc"].count == 1
    c(x.double())  # a new key, outside any span: no tracer records it
    c(x.double())
    assert (card["warm"], card["capture"]) == (2, 2)
    assert sorted(tracer.spans) == ["mapping", "mapping/local_ba",
                                    "mapping/local_ba/capture:inc",
                                    "mapping/local_ba/warm-up:inc"]
    off = Tracer(enabled=False)
    with off.span("frame"):
        c(x.half())
    assert not off.spans and card["warm"] == 3


def test_a_call_inside_a_stage_clock_runs_eagerly(card):
    """Inside a stamped step the nested captured sites run their function,
    whose stamps the step's own warm-up and capture take."""
    c = graphs.captured(lambda x: x * 3, "triple")
    x = torch.arange(3.0)
    with stage_clock(("start",), "cpu"):
        for _ in range(2):
            assert torch.equal(c(x), x * 3)
        assert graphs.last_call() == "eager"
        stage("start")
    assert not c._entries and card["warm"] == 0
