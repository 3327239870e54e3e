"""Motion-only BA's kernels on the card (``csrc/pose_lm.cu``; the CPU tests
are tests/test_torch_pose_lm.py): one LM iteration and one gate against
their plain versions on the same CUDA inputs, whole ``pose_only_optimize``
calls against the plain version, bits from run to run, in a vmapped batch
and in a CUDA graph, no host synchronisation, and the inputs the kernels
refuse.  The problem has the tracking step's shape: N = 2,000 rows at the
KITTI intrinsics, ~10% outliers, ~5% invalid rows (their points zero, as
the step's unmatched rows), ``inv_sigma2`` over 8 levels.  This file
imports no JAX, so on the card's machine it runs by a direct call:

    python3 -c "import sys; sys.path.insert(0, 'tests'); import test_torch_pose_lm_card as t; t.test_pose_lm_on_the_card()"

``python3 tests/test_torch_pose_lm_card.py`` runs the checks, then times
the kernels and their plain versions by CUDA events and prints one JSON
line.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from asdslam_torch.backend import ba  # noqa: E402
from asdslam_torch.ops import pose_lm  # noqa: E402
from asdslam_torch.utils import graphs  # noqa: E402

N = 2000
ROUNDS, ITERS = 4, 10
CALLS = 1 + ROUNDS * (ITERS + 1)  # operator calls of one pose_only_optimize
KITTI = (707.0912, 707.0912, 601.8873, 183.1104, 1241, 376)  # fx, fy, cx, cy, width, height


def step_problem(seed, n=N, device="cpu"):
    """(pose7 start, points [n, 3], uv [n, 2], inv_sigma2 [n], valid [n], K,
    true pose7) of a tracking-shaped problem, from a numpy seed: points
    seen at 4-60 m across a KITTI image, observed at the true pose with
    noise of their level's sigma (8 levels at 1.2), ~10% of them moved by
    up to 40 px, ~5% invalid with their points zero; the start 0.01 rad and
    ~0.1 m off the truth."""
    from asdslam_torch.geometry import se3

    g = np.random.default_rng(seed)
    fx, fy, cx, cy, w, h = KITTI
    truth = se3.pose_pack(*se3.se3_exp(torch.tensor(
        [0.02, -0.05, 0.01, 0.3, -0.1, 1.5], dtype=torch.float64)))
    R, t = (x.numpy() for x in se3.pose_unpack(truth))
    px = g.uniform([0, 0], [w, h], (n, 2))
    depth = 1.0 / g.uniform(1 / 60, 1 / 4, n)
    xc = np.stack([(px[:, 0] - cx) / fx * depth, (px[:, 1] - cy) / fy * depth, depth], 1)
    points = (xc - t) @ R  # R^T (xc - t)
    level = g.integers(0, 8, n)
    uv = px + g.normal(size=(n, 2)) * (1.2 ** level)[:, None]
    outlier = g.uniform(size=n) < 0.10
    uv[outlier] += g.uniform(-40, 40, (int(outlier.sum()), 2))
    valid = g.uniform(size=n) > 0.05
    points[~valid] = 0.0
    start = se3.pose_retract(truth, torch.tensor(g.normal(size=6) * ([0.006] * 3 + [0.06] * 3)))
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)

    return (f32(start), f32(points), f32(uv), f32(1.0 / 1.44 ** level),
            torch.as_tensor(valid).to(device), f32(K), f32(truth))


@contextlib.contextmanager
def plain_ops():
    """``pose_only_optimize`` on the plain versions, whatever the device
    (it calls the operators by module attribute)."""
    saved = pose_lm.pose_lm_step, pose_lm.pose_lm_gate
    pose_lm.pose_lm_step, pose_lm.pose_lm_gate = pose_lm.step_plain, pose_lm.gate_plain
    try:
        yield
    finally:
        pose_lm.pose_lm_step, pose_lm.pose_lm_gate = saved


def _rel(got, ref):
    """Largest difference over the reference's largest magnitude."""
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _equal(got, ref):
    return all(torch.equal(x, y) for x, y in zip(got, ref))


def _check_one_step(prob):
    """One LM iteration and one gate against the plain versions."""
    pose, pts, uv, inv, valid, K, _ = prob
    lam = torch.full((), 1e-3, device=pts.device)
    for use_huber in (True, False):
        inl, cost = pose_lm.gate_plain(pose, pts, uv, inv, valid, K, ba.CHI2_MONO, gate=False)
        got = pose_lm.pose_lm_step(pose, lam, cost, pts, uv, inv, inl, K, use_huber)
        ref = pose_lm.step_plain(pose, lam, cost, pts, uv, inv, inl, K, use_huber)
        assert _rel(got[0], ref[0]) <= 1e-5, (use_huber, got[0], ref[0])
        assert _rel(got[2], ref[2]) <= 1e-5, (use_huber, got[2], ref[2])
        assert torch.equal(got[1], ref[1]), (use_huber, got[1], ref[1])  # the same accept
        assert float(got[1]) < 1e-3  # an accepted step
    for gate, at in ((False, pose), (True, pose), (True, got[0])):
        inl_k, cost_k = pose_lm.pose_lm_gate(at, pts, uv, inv, valid, K, ba.CHI2_MONO, gate)
        inl_p, cost_p = pose_lm.gate_plain(at, pts, uv, inv, valid, K, ba.CHI2_MONO, gate)
        chi2, _ = pose_lm._chi2(at, pts, pose_lm._obs(pts, uv, inv, valid), K)
        near = (chi2 - ba.CHI2_MONO).abs() <= 1e-4
        assert torch.equal(inl_k & ~near, inl_p & ~near)
        same_rows = pose_lm._cost(at, pts, pose_lm._obs(pts, uv, inv, valid), K, inl_k)
        assert _rel(cost_k, same_rows) <= 1e-5, (gate, cost_k, same_rows)
        if torch.equal(inl_k, inl_p):
            assert _rel(cost_k, cost_p) <= 1e-5
    assert torch.equal(pose_lm.pose_lm_gate(pose, pts, uv, inv, valid, K, 5.991, False)[0],
                       valid)


def _check_whole_call(prob):
    """A whole 4 x 10 call against the plain version, and against itself."""
    pose, pts, uv, inv, valid, K, truth = prob
    args = (pose, pts, uv, inv, valid, K)
    before = pose_lm.launches
    got = ba.pose_only_optimize(*args)
    assert pose_lm.launches - before == CALLS
    with plain_ops():
        ref = ba.pose_only_optimize(*args)
    assert pose_lm.launches - before == CALLS
    assert float((got[0] - ref[0]).abs().max()) <= 1e-4, (got[0], ref[0])
    assert abs(int(got[2]) - int(ref[2])) <= 0.005 * int(ref[2]), (got[2], ref[2])
    assert int(got[2]) == int(got[1].sum()) and int(got[2]) > 0.7 * N
    assert float((got[0] - truth).abs().max()) < 1e-2  # it converged
    assert _equal(ba.pose_only_optimize(*args), got)  # run to run


def _check_batched(seed):
    """A vmapped batch of 4 is each problem's single call bit for bit, in
    one launch per operator call."""
    from asdslam_torch.utils import batching

    probs = [step_problem(seed + b, device="cuda") for b in range(4)]
    batch = [torch.stack(x) for x in zip(*(p[:5] for p in probs))]
    K = probs[0][5]
    run = functools.partial(ba.pose_only_optimize, K=K)
    before = pose_lm.launches
    with batching.per_sequence():
        out = torch.func.vmap(run)(*batch)
    assert pose_lm.launches - before == CALLS
    for b, p in enumerate(probs):
        assert _equal((x[b] for x in out), run(*p[:5]))


def _check_captured(prob):
    """The call replayed from ``graphs.captured`` is the eager kernel call
    bit for bit, and each replay counts its launches."""
    args = prob[:6]
    cap = graphs.captured(ba.pose_only_optimize, "test_pose_only_optimize")
    eager = ba.pose_only_optimize(*args)
    for _ in range(2):  # warm-up, capture
        cap(*args)
    before = pose_lm.launches
    replay = cap(*args)
    torch.cuda.synchronize()
    assert pose_lm.launches - before == CALLS
    assert _equal(replay, eager)


def _check_refusals(prob):
    pose, pts, uv, inv, valid, K, _ = prob
    lam, cost = torch.full((), 1e-3, device="cuda"), torch.ones((), device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        pose_lm.pose_lm_step(pose.double(), lam, cost, pts, uv, inv, valid, K, True)
    with pytest.raises(TypeError, match="dtype"):
        ba.pose_only_optimize(pose, pts.double(), uv, inv, valid, K)
    with pytest.raises(ValueError, match="contiguous"):
        pose_lm.pose_lm_gate(pose, pts, uv.t().contiguous().t(), inv, valid, K, 5.991)
    with pytest.raises(ValueError, match="on cpu"):
        pose_lm.pose_lm_gate(pose, pts, uv, inv, valid, K.cpu(), 5.991)


@pytest.mark.gpu
def test_pose_lm_on_the_card():
    """At the step's shape, over three seeds: the kernels against their
    plain versions, bits run to run, in a batch and in a graph, no host
    synchronisation in a call, and the inputs they refuse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    for seed in (3, 4, 5):
        prob = step_problem(seed, device="cuda")
        _check_one_step(prob)
        _check_whole_call(prob)
    _check_batched(11)
    _check_captured(step_problem(6, device="cuda"))
    prob = step_problem(7, device="cuda")
    chip_smoke.host_syncs(lambda: None)  # the debug mode's own first warning
    syncs = chip_smoke.host_syncs(lambda: ba.pose_only_optimize(*prob[:6]))
    assert syncs == [], syncs
    _check_refusals(prob)


def _graph_ms(fn, reps=20):
    """Device ms of one replay of ``fn`` captured in a CUDA graph, by CUDA
    events over ``reps`` replays."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _eager_ms(fn, reps=20):
    """Wall ms of one eager call by CUDA events (the host's launches
    included)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(seed=3):
    """ms at N = 2,000 (``pose_lm.launches`` untouched): a kernel step and
    gate (each a graph of 100 chained launches), a whole kernel call
    (captured, and eager), the plain step (a graph of 10) and the plain
    whole call (captured)."""
    pose, pts, uv, inv, valid, K, _ = step_problem(seed, device="cuda")
    args = (pose, pts, uv, inv, valid, K)
    inl, cost0 = pose_lm.gate_plain(pose, pts, uv, inv, valid, K, ba.CHI2_MONO, gate=False)
    lam0 = torch.full((), 1e-3, device="cuda")

    def chain(step, count):
        def run():
            p, lam, cost = pose, lam0, cost0
            for _ in range(count):
                p, lam, cost = step(p, lam, cost, pts, uv, inv, inl, K, True)
        return run

    def gates():
        for _ in range(100):
            pose_lm.pose_lm_gate(pose, pts, uv, inv, valid, K, ba.CHI2_MONO)

    out = {"step_ms": _graph_ms(chain(pose_lm.pose_lm_step, 100)) / 100,
           "gate_ms": _graph_ms(gates) / 100,
           "call_ms": _graph_ms(lambda: ba.pose_only_optimize(*args)),
           "call_eager_ms": _eager_ms(lambda: ba.pose_only_optimize(*args)),
           "plain_step_ms": _graph_ms(chain(pose_lm.step_plain, 10), 5) / 10}
    with plain_ops():
        out["plain_call_ms"] = _graph_ms(lambda: ba.pose_only_optimize(*args), 5)
    return out


if __name__ == "__main__":
    test_pose_lm_on_the_card()
    print("checks passed", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    launches = pose_lm.launches
    print(json.dumps({"card": card, "n": N, **timings(), "launches_checked": launches}))
