"""The CUDA-graph capture helper, ``asdslam_torch/utils/graphs.py``: the
port's counterpart of ``jax.jit``.

On the CPU the helper's card side (the device test, the warm-up, the
capture) is replaced by fakes: a fake graph runs the function on its static
buffers at each replay and writes into its static outputs, as a replayed
graph does.  That walks the keys, the static buffers, the clones, the
replayed host effects (K1's launch counters) and the cache bound here; the
captured fused step, extractor and LM iterations against their eager
functions, bit for bit, need the card (the ``gpu`` test, and
``chip_smoke.py`` phase 14).  The LM loops' split into iteration functions
is held to the JAX package by tests/test_torch_ba.py, test_torch_loop.py and
test_torch_parallel.py; here the split loops, run through the fake graphs,
equal the eager loops bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from asdslam_torch.backend import ba, global_ba, pose_graph
from asdslam_torch.config import SlamConfig
from asdslam_torch.frontend import track_step as tts
from asdslam_torch.frontend.extractor import make_extractor
from asdslam_torch.models import patch_descriptor
from asdslam_torch.ops import masked_nn as tk1
from asdslam_torch.utils import graphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_features=600, n_levels=4, image_width=320, image_height=240,
             fx=260.0, fy=260.0, cx=160.0, cy=120.0, local_ba_max_points=1024)
LM_SITES = (pose_graph, global_ba, ba)


class FakeGraph:
    """Replays by running the function on the static inputs and writing the
    results into the static outputs; nested captured calls run eagerly, as
    inside a capture."""

    def __init__(self, fn, args, kwargs, out):
        self.fn, self.args, self.kwargs, self.out = fn, args, kwargs, out

    def replay(self):
        graphs._tls.effects = []  # as in a capture: the entry replays the effects
        try:
            new = self.fn(*self.args, **self.kwargs)
        finally:
            graphs._tls.effects = None
        dst, src = [], []
        graphs._flatten(self.out, dst)
        graphs._flatten(new, src)
        for d, s in zip(dst, src):
            d.copy_(s)


@pytest.fixture
def card(monkeypatch):
    """The CPU as the card: every call with tensors takes the graph path.
    Yields a dict whose "stream" is the current stream's key and whose
    "warm" / "capture" count the warm-ups and captures."""
    state = {"stream": 1, "warm": 0, "capture": 0}

    def warm(fn, args, kwargs, device):
        state["warm"] += 1
        return fn(*args, **kwargs)

    def capture(fn, args, kwargs, device):
        state["capture"] += 1
        out = fn(*args, **kwargs)
        return FakeGraph(fn, args, kwargs, out), out

    monkeypatch.setattr(graphs, "_graph_device",
                        lambda leaves: leaves[0].device if leaves else None)
    monkeypatch.setattr(graphs, "_capturing", lambda: False)
    monkeypatch.setattr(graphs, "_stream_key", lambda device: state["stream"])
    monkeypatch.setattr(graphs, "_warm", warm)
    monkeypatch.setattr(graphs, "_capture", capture)
    for site in LM_SITES:  # module-level callables: no fake graph outlives the test
        site._lm_step._entries.clear()
    yield state
    for site in LM_SITES:
        site._lm_step._entries.clear()


def test_cpu_inputs_run_the_function():
    calls = []

    def fn(x, y=None):
        calls.append(x)
        return x * 2

    c = graphs.captured(fn, "double")
    x = torch.arange(4.0)
    assert c.eager is fn
    for _ in range(3):
        assert torch.equal(c(x), x * 2)
    assert len(calls) == 3 and calls[0] is x and not c._entries
    cfg = SlamConfig(**SMALL)
    step = tts.make_track_step(cfg, torch.eye(3), lambda img: None, device="cpu")
    assert not hasattr(step, "eager")  # the CPU step is the eager function


def test_warm_then_capture_then_replay(card):
    c = graphs.captured(lambda x: x + 1, "inc")
    x = torch.arange(3.0)
    outs = [c(x) for _ in range(4)]
    assert all(torch.equal(o, x + 1) for o in outs)
    assert (card["warm"], card["capture"]) == (1, 1)
    assert c.stats()[0]["replays"] == 3


def test_key_follows_shape_dtype_none_and_stream(card):
    c = graphs.captured(lambda x, y=None: x if y is None else x + y, "add")
    x4, x5 = torch.zeros(4), torch.zeros(5)
    for args in ((x4,), (x5,), (x4.double(),), (x4, x4), (x4, None), (x4, x4), (x4,)):
        c(*args)
    # x4, x5, double, (x4, x4), (x4, None): five keys; the two repeated
    # ones are captured at their second call
    assert len(c._entries) == 5 and card["capture"] == 2
    c(x4, x4)
    assert card["capture"] == 2 and len(c._entries) == 5
    card["stream"] = 2  # another stream: buffers of its own
    c(x4, x4)
    assert len(c._entries) == 6 and card["warm"] == 6


def test_constant_leaves_are_part_of_the_key(card):
    c = graphs.captured(lambda x, k: x * k, "scale")
    x = torch.ones(3)
    for k in (2, 3, 2, 3, 2):
        assert torch.equal(c(x, k), x * k)
    assert len(c._entries) == 2 and card["capture"] == 2


def test_chain_keeps_earlier_outputs(card):
    """Call k's outputs feed call k + 1; every returned value stays what it
    was when returned (the static outputs are overwritten at each replay,
    the returned clones are not)."""
    def step(x, s):
        return s * x + 1.0, (x.sum(), s.clone())

    c = graphs.captured(step, "chain")
    x, s = torch.arange(5.0), torch.tensor(2.0)
    kept, want = [], []
    xe = x
    for _ in range(6):
        x, (tot, s2) = c(x, s)
        kept.append((x, tot, s2))
        xe, (te, _) = step(xe, s)
        want.append((xe.clone(), te.clone()))
    for (x, tot, s2), (xe, te) in zip(kept, want):
        assert torch.equal(x, xe) and torch.equal(tot, te) and torch.equal(s2, s)
    assert card["capture"] == 1


def test_k1_counts_are_added_at_each_replay(card, monkeypatch):
    """A launch counted during the capture (where it runs nothing) counts
    once at each replay, under the replaying thread's call-site label."""
    monkeypatch.setattr(tk1.masked_nn, "launches", 0)
    monkeypatch.setattr(tk1.masked_nn, "by_site", {})

    def search(x):
        graphs.host_effect(tk1._count)  # what masked_nn does after a launch
        graphs.host_effect(tk1._count)
        return x * 3

    c = graphs.captured(search, "two launches")
    x = torch.ones(2)
    with tk1.call_site("step"):
        for _ in range(4):  # warm-up, capture + replay, two replays
            c(x)
    assert tk1.masked_nn.launches == 8 and tk1.masked_nn.by_site == {"step": 8}
    c(x)
    assert tk1.masked_nn.launches == 10 and tk1.masked_nn.by_site == {"step": 8}
    assert card["capture"] == 1


def test_cache_is_bounded(card):
    c = graphs.captured(lambda x: x - 1, "bounded")
    for n in range(1, 3 * graphs.MAX_GRAPHS):
        c(torch.zeros(n))
        c(torch.zeros(n))
        assert len(c._entries) <= graphs.MAX_GRAPHS
    warm = card["warm"]
    c(torch.zeros(1))  # dropped long ago: a new key, warmed again
    assert card["warm"] == warm + 1


def test_a_call_inside_a_capture_runs_eagerly(card):
    inner_calls = []

    def inner_fn(x):
        inner_calls.append(x)
        return x * 5

    inner = graphs.captured(inner_fn, "inner")
    outer = graphs.captured(lambda x: inner(x) + 1, "outer")
    x = torch.ones(3)
    for _ in range(5):
        assert torch.equal(outer(x), x * 5 + 1)
    # the outer warm-up warmed the inner; inside the outer capture (and its
    # replays) the inner ran its function: it never captured
    assert len(inner._entries) == 1 and inner.stats() == []
    assert card["capture"] == 1 and len(inner_calls) == 1 + 2 + 3


def test_host_effect_runs_at_once_outside_a_capture():
    seen = []
    graphs.host_effect(lambda: seen.append(1))
    assert seen == [1]


def test_missing_crow_is_no_bound_row():
    """The captured step passes an all -1 ``prev_crow`` where the caller
    passes None: the same result, so one graph serves both."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cfg = SlamConfig(**SMALL)
    torch.manual_seed(0)
    K, extract, frames_u8, poses, cand, state = chip_smoke.build_tracking(
        cfg, "cpu", descriptor_fn=patch_descriptor.apply)
    step = tts.make_track_step(cfg, K, extract, device="cpu")
    args = (frames_u8[1], state["pose"], state["vel"], state["feat"], state["geom"], cand)
    feat_a, res_a = step(*args)
    feat_b, res_b = step(*args, torch.full((cfg.n_features,), -1, dtype=torch.int32))
    for a, b in zip(chip_smoke.tree_leaves((feat_a, res_a)), chip_smoke.tree_leaves((feat_b, res_b))):
        assert chip_smoke.same_bits(a, b)


def _pose_graph_args():
    sys.path.insert(0, ROOT)
    import chip_smoke

    poses8, i, j, meas, w, fixed = map(torch.as_tensor, chip_smoke.pose_graph_problem_np())
    edges = pose_graph.PoseGraphEdges(i=i, j=j, meas=meas, weight=w,
                                      valid=torch.ones(len(w), dtype=torch.bool))
    return (poses8, edges, fixed), dict(iters=4, cg_iters=30)


def _gba_args():
    sys.path.insert(0, ROOT)
    import chip_smoke

    poses7, X, pt_valid, *obs, n_opt = chip_smoke.gba_problem_np()
    return ((torch.as_tensor(poses7), torch.as_tensor(X), torch.as_tensor(pt_valid),
             ba.Obs(*map(torch.as_tensor, obs)), torch.as_tensor(chip_smoke.SING_K)),
            dict(n_opt=n_opt, iters=4, cg_iters=20))


def _local_ba_args():
    sys.path.insert(0, ROOT)
    import chip_smoke

    problem, K, n_opt = chip_smoke.local_ba_problem(SlamConfig(**SMALL), "cpu", points=256,
                                                    obs=1024)
    return (problem, K), dict(n_opt=n_opt, iters=4)


@pytest.mark.parametrize("site, make", [
    ("essential graph", lambda: (pose_graph.optimize_pose_graph, _pose_graph_args())),
    ("global BA", lambda: (global_ba.global_bundle_adjust, _gba_args())),
    ("local BA", lambda: (ba.bundle_adjust, _local_ba_args())),
])
def test_lm_loops_through_the_graph_path(card, site, make):
    """Each LM loop with its iterations through the (fake) graphs equals
    the eager loop bit for bit: the iteration's inputs, constants and named
    tuples reach the static buffers and come back in place."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    fn, (args, kwargs) = make()
    captured_out = fn(*args, **kwargs)
    assert card["capture"] == 1
    with chip_smoke.eager_sites():
        eager_out = fn(*args, **kwargs)
    leaves_c, leaves_e = chip_smoke.tree_leaves(captured_out), chip_smoke.tree_leaves(eager_out)
    assert len(leaves_c) == len(leaves_e)
    for a, b in zip(leaves_c, leaves_e):
        assert chip_smoke.same_bits(a, b), site


@pytest.mark.gpu
def test_captured_sites_equal_eager_on_the_card():
    """The SMALL-config fused step over chained frames and the essential
    graph, captured against ``.eager``, bit for bit (chip_smoke.py phase
    14's checks at a small shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke

    cfg = SlamConfig(**SMALL)
    K, extract, frames_u8, poses, cand, state = chip_smoke.build_tracking(cfg, "cuda")
    step = tts.make_track_step(cfg, K, extract, device="cuda")
    chip_smoke.check_chain(step, frames_u8, state, cand, 4)
    chip_smoke.check_lm_call(pose_graph.optimize_pose_graph, *_on_card(*_pose_graph_args()))


def _on_card(args, kwargs):
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.cuda()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(move, x))
        return x
    return tuple(map(move, args)), kwargs


def test_make_extractor_is_captured_and_runs_eagerly_on_the_cpu():
    cfg = SlamConfig(**SMALL)
    extract = make_extractor(cfg, patch_descriptor.apply)
    assert isinstance(extract, graphs.Captured)
    img = torch.as_tensor(np.random.default_rng(0).random((240, 320), np.float32))
    a, b = extract(img), extract.eager(img)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not extract._entries
