"""The multi-sequence step's batch axis: the masked-NN search over a leading
batch axis (its plain version against the reference kernel under
``jax.vmap`` in Pallas interpret mode, and against per-problem calls bit for
bit), ``torch.func.vmap`` reaching one batched call, and the batched
tracking step (``track_step.make_batched_track_step``) bit for bit the
single step on each sequence, with the operations that run once per
sequence to make it so.  Inputs are made from numpy seeds.  The kernel's own batched launch is
held to its per-problem launches in the ``gpu`` test (skipped without a
card; on the card, where JAX is absent, call it directly: the JAX package is
imported only by the test that needs it)."""

import functools
import sys

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from asdslam_torch.backend import ba as tba
from asdslam_torch.frontend import track_step as tts
from asdslam_torch.ops import masked_nn as tk1
from asdslam_torch.ops import patches as tpatches
from asdslam_torch.parallel import dist as tdist
from asdslam_torch.parallel import multi_seq as tmulti
from asdslam_torch.utils import batching

LEVEL_WINDOW = (-1.0, 1.0)
B = 3


def _problems(n, m, d, batch=B, seed=0, exact=False):
    """``batch`` projection-search problems (numpy): genuine correspondences,
    duplicate columns, windows and levels that gate, a block of masked rows;
    problem 1 has every row invalid.  ``exact``: entries +-1/16 (every dot
    and norm exact in bf16 and f32, as the ORB embedding's)."""
    g = np.random.default_rng(seed)
    if exact:
        a = (np.sign(g.standard_normal((batch, n, d))) / 16).astype(np.float32)
        b = (np.sign(g.standard_normal((batch, m, d))) / 16).astype(np.float32)
    else:
        a = g.standard_normal((batch, n, d)).astype(np.float32)
        b = g.standard_normal((batch, m, d)).astype(np.float32)
        a /= np.linalg.norm(a, axis=-1, keepdims=True)
        b /= np.linalg.norm(b, axis=-1, keepdims=True)
    half = min(n, m) // 2
    b[:, :half] = a[:, :half] + (0 if exact else 0.05 * g.standard_normal((batch, half, d)))
    b[:, m - 1] = b[:, 7]
    uv_a = g.uniform(0, 300, (batch, n, 2)).astype(np.float32)
    uv_b = g.uniform(0, 300, (batch, m, 2)).astype(np.float32)
    uv_b[:, :half] = uv_a[:, :half] + 10 * g.standard_normal((batch, half, 2))
    valid_a = g.uniform(size=(batch, n)) > 0.1
    valid_a[:, :5] = False
    if batch > 1:
        valid_a[1] = False
    valid_b = g.uniform(size=(batch, m)) > 0.1
    lvl_a = g.integers(0, 4, (batch, n)).astype(np.int32)
    lvl_b = g.integers(0, 4, (batch, m)).astype(np.int32)
    lvl_b[:, :half] = lvl_a[:, :half]
    rad2 = ((40.0 + 40.0 * g.uniform(size=(batch, n))) ** 2).astype(np.float32)
    return [a, b, valid_a, valid_b, uv_a, uv_b, rad2, lvl_a, lvl_b]


def _torch(arrays):
    return tuple(torch.tensor(x) for x in arrays)


def _per_problem(args, b):
    return tuple(a[b] for a in args)


def _assert_equal(got, ref):
    """Every tensor leaf of two (nested) tuples bit for bit equal."""
    got, ref = tree_leaves(tuple(got)), tree_leaves(tuple(ref))
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------- #
# K1 over a leading batch axis
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("n, m", [(128, 192), (100, 77)])
def test_batched_plain_matches_jax_vmap(d, n, m):
    """The batched plain search against ``jax.vmap`` of the reference
    kernel (one pallas_call with a batch grid axis), in interpret mode: idx
    and the ratio test's ok exact, best within 1e-5 (tests/test_pallas_match.py's
    bar); N and M multiples of 64 and not."""
    import jax
    import jax.numpy as jnp
    from asdslam_tpu.ops import pallas_match

    arrays = _problems(n, m, d, seed=n + m + d)
    jfn = jax.vmap(functools.partial(pallas_match.masked_nn, level_window=LEVEL_WINDOW,
                                     interpret=True))
    ij, bj, sj = (np.asarray(x) for x in jfn(*(jnp.asarray(x) for x in arrays)))
    it, bt, st = (x.numpy() for x in tk1.masked_nn(*_torch(arrays), level_window=LEVEL_WINDOW))
    assert it.shape == bt.shape == (B, n)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal((bt <= 1.2) & (bt < 0.8 * st), (bj <= 1.2) & (bj < 0.8 * sj))
    np.testing.assert_allclose(bt, bj, atol=1e-5, rtol=0)
    assert (bt[1] == tk1.BIG).all() and (bt[0] < tk1.BIG).sum() > 10


@pytest.mark.parametrize("batch", [1, B])
@pytest.mark.parametrize("exact", [False, True])
def test_batched_plain_bitwise_per_problem(batch, exact):
    """One batched plain call is each problem's own call bit for bit (B = 1
    too, and the problem with every row invalid)."""
    args = _torch(_problems(150, 130, 128, batch=batch, seed=3, exact=exact))
    out = tk1.masked_nn(*args, level_window=LEVEL_WINDOW)
    for b in range(batch):
        _assert_equal((x[b] for x in out), tk1.masked_nn(*_per_problem(args, b),
                                                         level_window=LEVEL_WINDOW))
    if batch > 1:
        assert (out[1][1] == tk1.BIG).all()


def test_prepare_and_live_tiles_batched():
    """The kernel's preparation in plain PyTorch with a batch axis: each
    problem's ordering, tile summaries and live tile pairs are its own
    call's."""
    args = _torch(_problems(200, 150, 128, seed=4))
    prep_args = args[2:]
    prep = tk1.prepare_plain(*prep_args)
    live = tk1.live_tiles(prep.rows, prep.cols, LEVEL_WINDOW)
    assert live.shape[0] == B
    for b in range(B):
        one = tk1.prepare_plain(*_per_problem(prep_args, b))
        _assert_equal((prep.perm_a[b], prep.perm_b[b]), (one.perm_a, one.perm_b))
        for side, ref in ((prep.rows, one.rows), (prep.cols, one.cols)):
            _assert_equal((f[b] for f in side), ref)
        assert torch.equal(live[b], tk1.live_tiles(one.rows, one.cols, LEVEL_WINDOW))
    assert not live[1].any()  # every row invalid: nothing to visit


def test_vmap_reaches_one_batched_call(monkeypatch):
    """``torch.func.vmap`` of the wrapper is one call of the search on the
    stacked problems (the operator's vmap rule), equal to the batched call;
    unbatched inputs (one column side for every problem) are repeated."""
    args = _torch(_problems(96, 80, 128, seed=5))
    calls, real = [], tk1._run

    def counted(a, level_window):
        calls.append(tuple(x.shape for x in a))
        return real(a, level_window)

    monkeypatch.setattr(tk1, "_run", counted)
    search = functools.partial(tk1.masked_nn, level_window=LEVEL_WINDOW)
    _assert_equal(torch.func.vmap(search)(*args), search(*args))
    assert calls == [tuple(x.shape for x in args)] * 2
    del calls[:]
    cols = (1, 3, 5, 8)  # desc_b, valid_b, uv_b, levels_b: problem 0's for all
    dims = tuple(None if i in cols else 0 for i in range(9))
    shared = tuple(a[0] if i in cols else a for i, a in enumerate(args))
    out = torch.func.vmap(search, in_dims=dims)(*shared)
    assert len(calls) == 1 and calls[0][1] == (B, 80, 128)
    for b in range(B):
        one = tuple(a if i in cols else a[b] for i, a in enumerate(shared))
        _assert_equal((x[b] for x in out), search(*one))


def test_scratch_layout_is_b_blocks(monkeypatch):
    """A batch's scratch is B blocks of one problem's layout, keyed apart
    from one problem's (walked with the library's entry points stubbed)."""
    calls = []

    class Lib:
        @staticmethod
        def masked_nn_launch(*a):
            calls.append(a)
            return 0

    monkeypatch.setattr(tk1, "_lib", lambda: Lib)
    monkeypatch.setattr(tk1, "_layout", lambda n, m, d, batch=1: (256 * batch, {}, 1))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(tk1, "_scratch", {})
    args = _torch(_problems(70, 40, 128, seed=6))
    (idx, best, second), scratch = tk1._launch(args, LEVEL_WINDOW)
    assert idx.shape == best.shape == second.shape == (B, 70) and scratch.numel() == 256 * B
    one = tk1._launch(_per_problem(args, 0), LEVEL_WINDOW)[1]
    assert set(tk1._scratch) == {(None, 7, 70, 40, 128, B), (None, 7, 70, 40, 128)}
    assert one.numel() == 256
    assert [c[12] for c in calls] == [B, 1]  # the batch reaches the C call


# --------------------------------------------------------------------------- #
# The batched tracking step
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def dp_case():
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_torch_parallel import _tiny_dp_case

    return _tiny_dp_case("cpu")


@pytest.mark.parametrize("bound", [False, True])
def test_batched_step_bitwise(dp_case, bound):
    """The batched step (torch.func.vmap of the single step) on 4 sequences,
    with and without a candidate-row binding: each sequence's features and
    result are the single step's bit for bit."""
    cfg, K, extract, imgs, state = dp_case
    crow = None
    if bound:
        g = np.random.default_rng(7)
        crow = torch.tensor(g.integers(-1, cfg.local_ba_max_points, (4, cfg.n_features)),
                            dtype=torch.int32)
    feats, res = tts.make_batched_track_step(cfg, K, extract, device="cpu")(imgs, *state, crow)
    single = tts.make_track_step(cfg, K, extract, device="cpu")
    for b in range(4):
        f1, r1 = single(imgs[b], *(tmulti._take(x, b, "cpu") for x in state),
                        None if crow is None else crow[b])
        _assert_equal(tmulti._take(feats, b, "cpu"), f1)
        _assert_equal(tmulti._take(res, b, "cpu"), r1)


def test_dp_step_two_sequences_a_shard(dp_case):
    """Two shards of two sequences: each shard one batched call, each
    sequence its single step bit for bit."""
    cfg, K, extract, imgs, state = dp_case
    step = tmulti.make_dp_track_step(cfg, K, extract, tdist.make_mesh(2, "cpu"))
    assert len(step.steps) == 2
    feats, res = step(imgs, *state)
    single = tts.make_track_step(cfg, K, extract, device="cpu")
    for b in range(4):
        f1, r1 = single(imgs[b], *(tmulti._take(x, b, "cpu") for x in state))
        _assert_equal(tmulti._take(feats, b, "cpu"), f1)
        _assert_equal(tmulti._take(res, b, "cpu"), r1)


# --------------------------------------------------------------------------- #
# The operations that run once per sequence under the vmap
# --------------------------------------------------------------------------- #
def test_ic_angle_batched_bitwise():
    """Orientation over a batch of images: each image's angles are its own
    call's bit for bit (its sums and atan2 once per image)."""
    g = np.random.default_rng(8)
    imgs = torch.tensor(g.uniform(size=(B, 96, 128)).astype(np.float32))
    xy = torch.tensor(g.uniform(16, 80, (B, 70, 2)).astype(np.float32))
    with batching.per_sequence():
        out = torch.func.vmap(tpatches.ic_angle)(imgs, xy)
    for b in range(B):
        assert torch.equal(out[b], tpatches.ic_angle(imgs[b], xy[b]))


def test_pose_only_batched_bitwise():
    """Motion-only BA over a batch of problems: each pose, inlier mask and
    count is its own call's bit for bit (its normal equations, cost sums
    and pose products once per problem)."""
    g = np.random.default_rng(9)
    n = 150
    K = torch.tensor([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
    pts = g.uniform(-2, 2, (B, n, 3)) + [0, 0, 6]
    uv = 300.0 * pts[..., :2] / pts[..., 2:] + [160.0, 120.0] + g.normal(0, 1, (B, n, 2))
    uv[:, :10] += 40.0  # outliers
    pose = np.tile(np.float32([1, 0, 0, 0, 0.05, -0.03, 0.1]), (B, 1))
    args = (torch.tensor(pose), torch.tensor(pts, dtype=torch.float32),
            torch.tensor(uv, dtype=torch.float32), torch.ones((B, n)),
            torch.tensor(g.uniform(size=(B, n)) > 0.05))
    run = functools.partial(tba.pose_only_optimize, K=K, rounds=2, iters=4)
    with batching.per_sequence():
        out = torch.func.vmap(run)(*args)
    for b in range(B):
        _assert_equal((x[b] for x in out), run(*_per_problem(args, b)))
    assert (out[2] > 100).all()


def test_sequential_under_vmap():
    """``batching.sequential``: the function itself outside vmap; under it,
    in a ``per_sequence`` block, one call per sequence on a fresh copy of
    the sequence's inputs (an unbatched input passed as it is), results
    stacked; ``cpu_only`` on CPU tensors likewise; outside the block (any
    other transform) one call over the batch."""
    calls = []

    def gram(x, y, scale=1.0):
        calls.append((tuple(x.shape), x.storage_offset(), y.data_ptr()))
        return (x @ x.T) * scale, x.sum(dim=1) + y

    g = np.random.default_rng(11)
    x = torch.tensor(g.standard_normal((B, 5, 4)).astype(np.float32))
    y = torch.tensor(g.standard_normal(5).astype(np.float32))
    run = batching.sequential(gram, "test:gram")
    with batching.per_sequence():
        out = torch.func.vmap(lambda v: run(v, y, scale=2.0))(x)
    assert [c[:2] for c in calls] == [((5, 4), 0)] * B and {c[2] for c in calls} == {y.data_ptr()}
    for b in range(B):
        _assert_equal((o[b] for o in out), gram(x[b], y, scale=2.0))
    del calls[:]
    _assert_equal(run(x[0], y), gram(x[0], y))
    assert len(calls) == 2  # the direct call and the reference's
    a, c = (torch.tensor(g.standard_normal((B, 70)).astype(np.float32)) for _ in range(2))
    with batching.per_sequence():
        got = torch.func.vmap(batching.atan2)(a, c)
    for b in range(B):
        assert torch.equal(got[b], torch.atan2(a[b], c[b]))
    del calls[:]
    torch.func.vmap(run, in_dims=(0, None))(x, y)  # outside the block: one call
    assert [c[0] for c in calls] == [(5, 4)] and len(calls) == 1


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_batched_kernel_on_the_card(d):
    """One batched launch (counted once): bit for bit its per-problem
    launches and, on exact (+-1/16) problems, its batched plain version; a
    batch of one is the unbatched launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for exact in (False, True):
        args = tuple(t.cuda() for t in _torch(_problems(2000, 2000, d, batch=4, exact=exact)))
        before = tk1.masked_nn.launches
        out = tk1.masked_nn(*args, level_window=LEVEL_WINDOW)
        assert tk1.masked_nn.launches == before + 1
        for b in range(4):
            _assert_equal((x[b] for x in out), tk1.masked_nn(*_per_problem(args, b),
                                                             level_window=LEVEL_WINDOW))
        if exact:
            _assert_equal(out, tk1.masked_nn_plain(*args, LEVEL_WINDOW))
        one = tuple(a[:1] for a in args)
        _assert_equal((x[0] for x in tk1.masked_nn(*one, level_window=LEVEL_WINDOW)),
                      tk1.masked_nn(*_per_problem(args, 0), level_window=LEVEL_WINDOW))
