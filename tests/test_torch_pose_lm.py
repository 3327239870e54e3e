"""Motion-only BA's operators on the CPU (``ops/pose_lm.py``; the kernels
themselves are checked on the card by tests/test_torch_pose_lm_card.py):
``pose_only_optimize`` makes 1 + rounds * (iters + 1) operator calls, CPU
tensors take the plain versions and launch nothing, the operators' vmap
rules give each problem its own call's bits, the plain step's accept and
damping rule, and the checks that refuse what the kernels cannot take."""

import functools
import sys

import pytest
import torch

from asdslam_torch.backend import ba
from asdslam_torch.ops import pose_lm
from asdslam_torch.utils import batching

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_pose_lm_card import step_problem  # noqa: E402

N_SMALL = 300


@pytest.fixture(scope="module")
def prob():
    return step_problem(1, n=N_SMALL)


@pytest.mark.parametrize("rounds,iters", [(4, 10), (2, 3), (1, 1)])
def test_operator_calls(prob, monkeypatch, rounds, iters):
    """One gate before the first round, then ``iters`` steps and a gate a
    round; on CPU tensors none of them launches a kernel."""
    calls = []

    def counted(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(pose_lm, "pose_lm_step", counted("step", pose_lm.pose_lm_step))
    monkeypatch.setattr(pose_lm, "pose_lm_gate", counted("gate", pose_lm.pose_lm_gate))
    before = pose_lm.launches
    pose, inl, n_in = ba.pose_only_optimize(*prob[:6], rounds=rounds, iters=iters)
    assert calls == ["gate"] + (["step"] * iters + ["gate"]) * rounds
    assert len(calls) == 1 + rounds * (iters + 1)
    assert pose_lm.launches == before
    assert int(n_in) == int(inl.sum()) > 0


def test_converges(prob):
    """From ~0.01 rad and ~0.1 m off, the 4 x 10 call lands on the truth
    and gates the moved observations out."""
    pose, inl, n_in = ba.pose_only_optimize(*prob[:6])
    assert float((pose - prob[6]).abs().max()) < 1e-2
    assert int(n_in) > 0.7 * N_SMALL
    assert not (inl & ~prob[4]).any()  # no invalid row is an inlier


def test_cpu_takes_the_plain_versions(prob):
    """On CPU tensors the operators are their plain versions, bit for bit;
    the ungated gate gives ``valid`` and its cost."""
    pose, pts, uv, inv, valid, K, _ = prob
    lam = torch.full((), 1e-3)
    inl, cost = pose_lm.pose_lm_gate(pose, pts, uv, inv, valid, K, 5.991, gate=False)
    assert torch.equal(inl, valid) and inl is not valid
    for use_huber in (True, False):
        got = pose_lm.pose_lm_step(pose, lam, cost, pts, uv, inv, inl, K, use_huber)
        ref = pose_lm.step_plain(pose, lam, cost, pts, uv, inv, inl, K, use_huber)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    got = pose_lm.pose_lm_gate(got[0], pts, uv, inv, valid, K, 5.991)
    ref = pose_lm.gate_plain(ref[0], pts, uv, inv, valid, K, 5.991)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert not torch.equal(got[0], valid)  # the gate took some rows out


def test_step_accepts_and_rejects(prob):
    """A step that lowers the cost is taken and divides the damping by
    ~3; one that cannot (its state's cost already 0) keeps the pose and
    cost and multiplies the damping by 4."""
    pose, pts, uv, inv, valid, K, _ = prob
    lam = torch.full((), 1e-3)
    inl, cost = pose_lm.gate_plain(pose, pts, uv, inv, valid, K, 5.991, gate=False)
    p1, lam1, cost1 = pose_lm.pose_lm_step(pose, lam, cost, pts, uv, inv, inl, K, True)
    assert float(cost1) < float(cost) and not torch.equal(p1, pose)
    assert torch.equal(lam1, torch.clamp(lam * 0.33, min=1e-9))
    zero = torch.zeros(())
    p2, lam2, cost2 = pose_lm.pose_lm_step(pose, lam, zero, pts, uv, inv, inl, K, True)
    assert torch.equal(p2, pose) and torch.equal(cost2, zero)
    assert torch.equal(lam2, lam * 4.0)
    big = torch.full((), 1e6)
    assert torch.equal(pose_lm.pose_lm_step(pose, big, zero, pts, uv, inv, inl, K, True)[1],
                       big)  # the damping's ceiling


def test_vmap_rule_per_problem():
    """Under ``torch.func.vmap`` the operators run once over the batch, and
    each problem's results are its own call's bits (K shared: unbatched)."""
    probs = [step_problem(20 + b, n=120) for b in range(3)]
    batch = [torch.stack(x) for x in zip(*(p[:5] for p in probs))]
    K = probs[0][5]
    lam = torch.full((3,), 1e-3)
    inl, cost = torch.func.vmap(
        lambda *a: pose_lm.pose_lm_gate(*a, K, 5.991, gate=False))(*batch)
    out = torch.func.vmap(
        lambda p, l, c, x, u, s, m: pose_lm.pose_lm_step(p, l, c, x, u, s, m, K, True))(
        batch[0], lam, cost, *batch[1:4], inl)
    for b, p in enumerate(probs):
        ref_inl, ref_cost = pose_lm.gate_plain(*p[:5], K, 5.991, gate=False)
        assert torch.equal(inl[b], ref_inl) and torch.equal(cost[b], ref_cost)
        ref = pose_lm.step_plain(p[0], lam[b], ref_cost, *p[1:4], ref_inl, K, True)
        assert all(torch.equal(x[b], y) for x, y in zip(out, ref))
    run = functools.partial(ba.pose_only_optimize, K=K, rounds=2, iters=3)
    with batching.per_sequence():
        whole = torch.func.vmap(run)(*batch)
    for b, p in enumerate(probs):
        assert all(torch.equal(x[b], y) for x, y in zip(whole, run(*p[:5])))


def _step_inputs(n=8, lead=()):
    f = functools.partial(torch.zeros, dtype=torch.float32)
    return [f(lead + (7,)), f(lead), f(lead), f(lead + (n, 3)), f(lead + (n, 2)),
            f(lead + (n,)), torch.zeros(lead + (n,), dtype=torch.bool), f(lead + (3, 3))]


@pytest.mark.parametrize("fault,slot,error,match", [
    ("float64", 0, TypeError, "pose has dtype torch.float64"),
    ("float64", 3, TypeError, "points has dtype"),
    ("float32 mask", 6, TypeError, "inliers has dtype torch.float32"),
    ("non-contiguous", 4, ValueError, "uv is not contiguous"),
    ("rows", 5, ValueError, r"inv_sigma2 has shape \(7,\), expected \(8,\)"),
    ("K", 7, ValueError, r"K has shape \(9,\)"),
    ("unbatched", 1, ValueError, r"lam has shape \(2,\), expected \(\)"),
    ("not a tensor", 2, TypeError, "cost must be a tensor"),
])
def test_validate_refuses(fault, slot, error, match):
    """The checks before a launch name the input the kernel cannot take
    (they run the same on CPU tensors)."""
    args = _step_inputs()
    t = args[slot]
    args[slot] = {"float64": lambda: t.double(), "float32 mask": lambda: t.float(),
                  "non-contiguous": lambda: torch.zeros(2, 8).t(),
                  "rows": lambda: t[:7], "K": lambda: t.reshape(9),
                  "unbatched": lambda: torch.zeros(2), "not a tensor": lambda: 1.0}[fault]()
    with pytest.raises(error, match=match):
        pose_lm._validate("pose_lm_step", pose_lm._STEP_NAMES, args, pose_lm._STEP_DTYPES,
                          pose_lm._STEP_SHAPES)


def test_validate_batches():
    """A leading batch axis on every input is B problems; an empty batch is
    refused."""
    assert pose_lm._validate("pose_lm_step", pose_lm._STEP_NAMES, _step_inputs(5, (3,)),
                             pose_lm._STEP_DTYPES, pose_lm._STEP_SHAPES) == ((3,), 5, 3)
    assert pose_lm._validate("pose_lm_step", pose_lm._STEP_NAMES, _step_inputs(0),
                             pose_lm._STEP_DTYPES, pose_lm._STEP_SHAPES) == ((), 0, 1)
    with pytest.raises(ValueError, match="empty batch"):
        pose_lm._validate("pose_lm_step", pose_lm._STEP_NAMES, _step_inputs(5, (0,)),
                          pose_lm._STEP_DTYPES, pose_lm._STEP_SHAPES)
