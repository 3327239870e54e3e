"""Parity of the port's matchers (asdslam_torch.ops.match, ops.masked_nn)
with the JAX package on the same numpy inputs; the masked-NN kernel's
ordering and tile culling walked in Python; and the CUDA kernel against its
plain version (on a CUDA device only).  Indices and masks exact; distances
1e-5 on the CPU, 5e-5 for the kernel (its tensor-core dot sums in another
order)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asdslam_tpu.ops import match as jmatch
from asdslam_tpu.ops import pallas_match
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.frontend import extractor as text
from asdslam_torch.geometry import se3 as tse3
from asdslam_torch.io import synthetic as tsyn
from asdslam_torch.models import asdnet as tnet
from asdslam_torch.ops import masked_nn as tk1
from asdslam_torch.ops import match as tmatch

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "asdnet_weights.pkl")


def _problem(seed, n=300, m=257, d=128, tie_rows=8):
    """The problem of tests/test_pallas_match.py, made with numpy: genuine
    correspondences, duplicate columns 100<-3 and m-1<-7 (cross-tile ties),
    rows equal to a column, windows and levels that gate."""
    g = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    desc_a = unit(g.standard_normal((n, d)))
    desc_b = unit(g.standard_normal((m, d)))
    half = m // 2
    desc_b[:half] = unit(desc_a[:half] + 0.05 * g.standard_normal((half, d)))
    desc_b[100] = desc_b[3]
    desc_b[m - 1] = desc_b[7]
    desc_a[:tie_rows] = desc_b[3]
    uv_a = g.uniform(0, 600, (n, 2)).astype(np.float32)
    uv_b = g.uniform(0, 600, (m, 2)).astype(np.float32)
    uv_b[:half] = uv_a[:half] + 20 * g.standard_normal((half, 2)).astype(np.float32)
    valid_a = g.uniform(size=n) > 0.1
    valid_b = g.uniform(size=m) > 0.1
    lvl_a = g.integers(0, 4, n).astype(np.int32)
    lvl_b = g.integers(0, 4, m).astype(np.int32)
    lvl_b[:half] = lvl_a[:half]
    radius = (60.0 + 40.0 * g.uniform(size=n)).astype(np.float32)
    return dict(desc_a=desc_a, desc_b=desc_b, uv_a=uv_a, uv_b=uv_b, valid_a=valid_a,
                valid_b=valid_b, lvl_a=lvl_a, lvl_b=lvl_b, radius=radius)


def _both(p, **kw):
    """search_projection on both sides: the JAX distance-matrix path and the
    port's CPU path."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    j = jmatch.search_projection(
        jnp.asarray(p["desc_a"]), jnp.asarray(p["desc_b"]), jnp.asarray(p["uv_a"]),
        jnp.asarray(p["uv_b"]), jnp.asarray(p["valid_a"]), jnp.asarray(p["valid_b"]),
        jnp.asarray(p["radius"]), 1.2, **jkw)
    t = tmatch.search_projection(
        torch.tensor(p["desc_a"]), torch.tensor(p["desc_b"]), torch.tensor(p["uv_a"]),
        torch.tensor(p["uv_b"]), torch.tensor(p["valid_a"]), torch.tensor(p["valid_b"]),
        torch.tensor(p["radius"]), 1.2, **tkw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_same(j, t):
    (ij, dj, okj), (it, dt, okt) = j, t
    np.testing.assert_array_equal(okj, okt)
    np.testing.assert_array_equal(ij[okj], it[okt])
    np.testing.assert_allclose(dj[okj], dt[okt], atol=1e-5, rtol=0)


@pytest.mark.parametrize("ratio", [1.0, 0.8])
def test_search_projection_parity(ratio):
    p = _problem(0)
    j, t = _both(p, ratio=ratio, pred_level_a=p["lvl_a"], levels_b=p["lvl_b"])
    _assert_same(j, t)
    assert j[2].sum() > 20


def test_search_projection_skip_b_and_masked_rows():
    p = _problem(1)
    p["valid_a"][:40] = False
    skip_b = np.random.default_rng(2).uniform(size=p["desc_b"].shape[0]) > 0.5
    j, t = _both(p, ratio=0.9, pred_level_a=p["lvl_a"], levels_b=p["lvl_b"], skip_b=skip_b)
    _assert_same(j, t)
    assert not t[2][:40].any()


def test_search_projection_no_level_gate():
    p = _problem(3)
    j, t = _both(p, ratio=1.0)
    _assert_same(j, t)


def test_search_window_parity():
    p = _problem(4)
    g = np.random.default_rng(4)
    ang_a = g.uniform(-np.pi, np.pi, p["desc_a"].shape[0]).astype(np.float32)
    ang_b = g.uniform(-np.pi, np.pi, p["desc_b"].shape[0]).astype(np.float32)
    args = (p["desc_a"], p["desc_b"], p["uv_a"], p["uv_b"], p["valid_a"], p["valid_b"])
    j = jmatch.search_window(*map(jnp.asarray, args), radius=80.0, max_dist=1.2, ratio=0.9,
                             angles_a=jnp.asarray(ang_a), angles_b=jnp.asarray(ang_b),
                             levels_a=jnp.asarray(p["lvl_a"]), levels_b=jnp.asarray(p["lvl_b"]),
                             check_rotation=True)
    t = tmatch.search_window(*map(torch.tensor, args), radius=80.0, max_dist=1.2, ratio=0.9,
                             angles_a=torch.tensor(ang_a), angles_b=torch.tensor(ang_b),
                             levels_a=torch.tensor(p["lvl_a"]), levels_b=torch.tensor(p["lvl_b"]),
                             check_rotation=True)
    _assert_same([np.asarray(x) for x in j], [x.numpy() for x in t])


def test_rotation_consistency_tied_histogram():
    """Four bins with equal counts compete for the top 3: the lower bins win,
    as with jax.lax.top_k."""
    n_per, bins = 5, [4, 9, 17, 25]
    width = 2 * np.pi / 30
    ang_a = np.concatenate([np.full(n_per, (b + 0.5) * width) for b in bins]).astype(np.float32)
    ang_a = np.concatenate([ang_a, np.float32([(12 + 0.5) * width] * 2)])
    n = ang_a.shape[0]
    ang_b = np.zeros(8, np.float32)
    idx = np.arange(n, dtype=np.int32) % 8
    valid = np.ones(n, bool)
    keep_j = np.asarray(jmatch.rotation_consistency(
        jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx), jnp.asarray(valid)))
    keep_t = tmatch.rotation_consistency(
        torch.tensor(ang_a), torch.tensor(ang_b), torch.tensor(idx), torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(keep_j, keep_t)
    assert keep_t.sum() == 3 * n_per and not keep_t[3 * n_per:].any()


def test_masked_nn_plain_matches_pallas_kernel():
    """The port's plain masked-NN against the reference kernel itself, run
    in Pallas interpret mode: idx, best and second."""
    p = _problem(5)
    p["valid_a"][:40] = False
    rad2 = p["radius"] * p["radius"]
    ij, bj, sj = pallas_match.masked_nn(
        jnp.asarray(p["desc_a"]), jnp.asarray(p["desc_b"]), jnp.asarray(p["valid_a"]),
        jnp.asarray(p["valid_b"]), jnp.asarray(p["uv_a"]), jnp.asarray(p["uv_b"]),
        jnp.asarray(rad2), jnp.asarray(p["lvl_a"]), jnp.asarray(p["lvl_b"]), (-1.0, 1.0),
        interpret=True)
    it, bt, st = tk1.masked_nn(
        torch.tensor(p["desc_a"]), torch.tensor(p["desc_b"]), torch.tensor(p["valid_a"]),
        torch.tensor(p["valid_b"]), torch.tensor(p["uv_a"]), torch.tensor(p["uv_b"]),
        torch.tensor(rad2), torch.tensor(p["lvl_a"]), torch.tensor(p["lvl_b"]), (-1.0, 1.0))
    bj, sj = np.asarray(bj), np.asarray(sj)
    clear = (sj - bj) > 1e-4
    np.testing.assert_array_equal(np.asarray(ij)[clear], it.numpy()[clear])
    np.testing.assert_allclose(bj, bt.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sj, st.numpy(), atol=1e-5, rtol=0)
    assert (bt.numpy()[:40] == tk1.BIG).all()


def test_masked_nn_raises_on_a_device_without_kernel():
    """Only CPU tensors take the plain version; any other device without the
    kernel raises instead of falling back."""
    p = _problem(6)
    with pytest.raises(ValueError):
        tk1.masked_nn(torch.tensor(p["desc_a"]).to("meta"), torch.tensor(p["desc_b"]).to("meta"),
                      torch.tensor(p["valid_a"]).to("meta"), torch.tensor(p["valid_b"]).to("meta"))


# --------------------------------------------------------------------------- #
# The kernel's ordering and culling, walked in Python
# --------------------------------------------------------------------------- #
LEVEL_WINDOW = (-1.0, 1.0)


def _k1_args(p, rad2="radius"):
    """masked_nn's torch arguments for a problem dict (numpy arrays)."""
    r2 = None if rad2 is None else torch.tensor(p["radius"] ** 2)
    return [torch.tensor(p[k]) for k in ("desc_a", "desc_b", "valid_a", "valid_b", "uv_a", "uv_b")] \
        + [r2, torch.tensor(p["lvl_a"]), torch.tensor(p["lvl_b"])]


def _frame_problem():
    """Motion-search inputs from two rendered corridor frames: the features
    of frame 0 as rows, frame 1's as columns, windows of 15 * 1.2^level px."""
    cfg = TConfig(n_features=600, n_levels=4, image_width=320, image_height=240,
                  fx=260.0, fy=260.0, cx=160.0, cy=120.0)
    K = torch.tensor([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    net = tnet.ASDNet()
    net.load_state_dict(tnet.load_weights(WEIGHTS))
    extract = text.make_extractor(cfg, lambda x: net(x, compute_dtype=torch.float32))
    frames, _ = tsyn.render_sequence(K, 2, 240, 320, step=0.3, turn=0.004, device="cpu")
    fa, fb = [extract((f * 255.0).clamp(0, 255).to(torch.uint8).float() / 255.0) for f in frames]
    radius = 15.0 * 1.2 ** fa.level.numpy().astype(np.float32)
    return dict(desc_a=fa.desc.numpy(), desc_b=fb.desc.numpy(), uv_a=fa.uv.numpy(),
                uv_b=fb.uv.numpy(), valid_a=fa.valid.numpy(), valid_b=fb.valid.numpy(),
                lvl_a=fa.level.numpy(), lvl_b=fb.level.numpy(), radius=radius.astype(np.float32))


def _edge_problem(case):
    """The contract's edge cases, on top of the tie problem."""
    p = _problem(11, n=1100, m=2001) if case == "ragged_m" else _problem(11)
    if case == "all_gated_out":
        p["radius"][:] = 0.0
        p["uv_b"] += 0.5
    elif case == "n_1":
        p = {k: (v[:1] if k in ("desc_a", "uv_a", "valid_a", "lvl_a", "radius") else v)
             for k, v in p.items()}
        p["valid_a"][0] = True
    elif case == "m_1":
        p = {k: (v[:1] if k in ("desc_b", "uv_b", "valid_b", "lvl_b") else v)
             for k, v in p.items()}
        p["uv_a"][:] = p["uv_b"][0]
        p["valid_a"][:] = True
        p["valid_b"][:] = True
        p["lvl_a"][:] = p["lvl_b"][0]
    elif case == "dup_tile_and_cell":
        # columns 63 and 64 (a 64-column tile boundary) hold one descriptor at
        # x = 31.5 and 32.5 (a 32-px cell boundary); rows 0-3 sit between them
        p["desc_b"][64] = p["desc_b"][63]
        p["uv_b"][63] = (31.5, 100.0)
        p["uv_b"][64] = (32.5, 100.0)
        p["valid_b"][63:65] = True
        p["lvl_b"][63:65] = 1
        p["desc_a"][:4] = p["desc_b"][63]
        p["uv_a"][:4] = (32.0, 100.0)
        p["valid_a"][:4] = True
        p["lvl_a"][:4] = 1
        p["radius"][:4] = 5.0
    elif case == "nonfinite_uv":
        p["valid_a"][:8] = True
        p["uv_a"][0] = (np.nan, 10.0)
        p["uv_a"][1] = (np.inf, 10.0)
        p["uv_a"][2] = (-np.inf, np.inf)
        p["uv_a"][3] = (np.inf, 10.0)
        p["radius"][3] = np.inf
        p["radius"][4] = np.inf     # a finite row with an infinite window
        p["radius"][5] = np.nan
        p["uv_b"][5] = (np.nan, 3.0)
        p["uv_b"][6] = (np.inf, 3.0)
    return p


EDGE_CASES = ("all_gated_out", "n_1", "m_1", "ragged_m", "no_window",
              "dup_tile_and_cell", "nonfinite_uv")


def _tile_walk(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, lvl_a, lvl_b, lw):
    """The kernel's algorithm in plain PyTorch: order by cell, summarise the
    tiles, visit only the live tile pairs, and keep a running top-2 per row
    ordered by (d, original column).  Also checks that every gated-in pair
    lies in a live tile pair.  Returns (idx, best, second, live share)."""
    uv_a, uv_b, rad2, lvl_a, lvl_b = tk1._defaults(desc_a, desc_b, uv_a, uv_b, rad2, lvl_a, lvl_b)
    prep = tk1.prepare_plain(valid_a, valid_b, uv_a, uv_b, rad2, lvl_a, lvl_b)
    n = desc_a.shape[0]
    gated = tk1.gate_plain(valid_a, valid_b, uv_a, uv_b, rad2, lvl_a, lvl_b, lw)
    culled, live = tk1.culled_gated_pairs(prep, gated, lw)
    assert culled == 0, f"culled tile pairs hold {culled} gated-in pairs"
    pa, pb = prep.perm_a, prep.perm_b

    a2, b2 = (desc_a * desc_a).sum(1), (desc_b * desc_b).sum(1)
    a16 = desc_a.to(torch.bfloat16).to(torch.float32)
    b16 = desc_b.to(torch.bfloat16).to(torch.float32)
    best = torch.full((n,), tk1.BIG)
    second = torch.full((n,), tk1.BIG)
    idx = torch.zeros(n, dtype=torch.int64)
    for rt, ct in live.nonzero().tolist():
        rows = pa[rt * tk1.TILE:(rt + 1) * tk1.TILE]
        cols = pb[ct * tk1.TILE:(ct + 1) * tk1.TILE]
        rows, cols = rows[rows >= 0], torch.sort(cols[cols >= 0]).values
        ok = gated[rows][:, cols]
        d = torch.clamp(a2[rows, None] + b2[None, cols] - 2.0 * (a16[rows] @ b16[cols].T), min=0.0)
        d = torch.where(ok, d, float("inf"))
        tb, ti = d.min(dim=1)  # first occurrence: the lowest column on ties
        ts = torch.where(torch.arange(len(cols))[None, :] == ti[:, None], float("inf"), d).amin(dim=1)
        tj = cols[ti]
        has = tb < float("inf")
        b0, i0, s0 = best[rows], idx[rows], second[rows]
        win = has & ((tb < b0) | ((tb == b0) & (tj < i0)))
        s_new = torch.minimum(torch.minimum(s0, ts.clamp(max=tk1.BIG)), torch.where(win, b0, tb))
        second[rows] = torch.where(has, s_new, s0)
        best[rows] = torch.where(win, tb, b0)
        idx[rows] = torch.where(win, tj, i0)
    return idx.to(torch.int32), best, second, float(live.float().mean())


def _assert_k1_close(got, ref, atol, max_dist=1.2, ratio=0.8):
    """ok (the ratio test's outcome) exact, idx exact on rows whose best is
    clear of the second, best and second within atol."""
    (ig, bg, sg), (ir, br, sr) = [[np.asarray(x) for x in t] for t in (got, ref)]
    np.testing.assert_array_equal((bg <= max_dist) & (bg < ratio * sg),
                                  (br <= max_dist) & (br < ratio * sr))
    clear = (sr - br) > 1e-4
    np.testing.assert_array_equal(ig[clear], ir[clear])
    np.testing.assert_allclose(bg, br, atol=atol, rtol=0)
    np.testing.assert_allclose(sg, sr, atol=atol, rtol=0)


def _jax_k1(args, lw):
    ja = [None if a is None else jnp.asarray(a.numpy()) for a in args]
    return pallas_match.masked_nn(*ja, lw, interpret=True)


@pytest.fixture(scope="module")
def frame_problem():
    return _frame_problem()


@pytest.mark.parametrize("source", ["tie_problem", "masked_rows", "frame_features"])
def test_masked_nn_tile_walk(source, frame_problem):
    """Culling and ordering as the kernel does them, walked in Python, give
    the plain search's and the reference kernel's results."""
    if source == "frame_features":
        p = frame_problem
    else:
        p = _problem(12, n=700, m=600)
        if source == "masked_rows":
            p["valid_a"][:100] = False
            p["valid_b"][::3] = False
    args = _k1_args(p)
    walk = _tile_walk(*args, LEVEL_WINDOW)
    plain = tk1.masked_nn_plain(*args, LEVEL_WINDOW)
    _assert_k1_close(walk[:3], plain, 1e-5)
    _assert_k1_close(walk[:3], _jax_k1(args, LEVEL_WINDOW), 1e-5)
    assert (plain[1] < tk1.BIG).sum() > 50
    if source == "frame_features":
        assert walk[3] < 1.0, f"live tile share {walk[3]}"  # the windows cull (0.73 here)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_masked_nn_edge_cases(case):
    """The contract's edge cases: the plain search against the reference
    kernel (interpret mode), and the tile walk against both."""
    p = _edge_problem(case)
    args = _k1_args(p, rad2=None if case == "no_window" else "radius")
    plain = tk1.masked_nn(*args, LEVEL_WINDOW)
    _assert_k1_close(plain, _jax_k1(args, LEVEL_WINDOW), 1e-5)
    _assert_k1_close(_tile_walk(*args, LEVEL_WINDOW)[:3], plain, 1e-5)
    idx, best, second = [x.numpy() for x in plain]
    if case == "all_gated_out":
        assert (idx == 0).all() and (best == tk1.BIG).all() and (second == tk1.BIG).all()
    if case == "m_1":
        assert (second == tk1.BIG).all() and (best < tk1.BIG).any()
    if case == "n_1":
        assert best[0] < tk1.BIG
    if case == "dup_tile_and_cell":
        assert (idx[:4] == 63).all() and (second[:4] == best[:4]).all()
    if case == "nonfinite_uv":
        assert best[0] == tk1.BIG and best[5] == tk1.BIG and best[4] < tk1.BIG


@pytest.mark.gpu
def test_masked_nn_kernel_matches_plain_on_cuda(frame_problem):
    """The kernel on the walk's and the edge cases' inputs, and twice on the
    same inputs with bitwise-equal results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    problems = [(c, _edge_problem(c)) for c in EDGE_CASES]
    problems += [("tie_problem", _problem(12, n=700, m=600)),
                 ("motion_shape", _problem(8, n=2000, m=2000)),
                 ("frame_features", frame_problem)]
    for case, p in problems:
        args = [None if a is None else a.cuda()
                for a in _k1_args(p, rad2=None if case == "no_window" else "radius")]
        before = tk1.masked_nn.launches
        got = tk1.masked_nn(*args, LEVEL_WINDOW)
        assert tk1.masked_nn.launches == before + 1
        again = tk1.masked_nn(*args, LEVEL_WINDOW)
        plain = tk1.masked_nn(*[None if a is None else a.cpu() for a in args], LEVEL_WINDOW)
        torch.cuda.synchronize()
        for x, y in zip(got, again):
            assert torch.equal(x, y), case
        _assert_k1_close([x.cpu() for x in got], plain, 5e-5)


def test_scratch_cache_is_bounded_and_keyed_by_shape(monkeypatch):
    """The wrapper's scratch buffers: one per (device, stream, N, M), so a
    call never gets a buffer sized for another shape, and the table is
    emptied before it passes 17 entries (the caching allocator hands a freed
    buffer's memory only to later work of the same stream, so a queued launch
    keeps what it reads).  Walked on the CPU with the launch itself stubbed."""
    calls = []

    class Lib:
        @staticmethod
        def masked_nn_launch(*a):
            calls.append(a)
            return 0

    monkeypatch.setattr(tk1, "_lib", lambda: Lib)
    monkeypatch.setattr(tk1, "_layout", lambda n, m: (64 * (n + m), {}, 1))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor has no index
    monkeypatch.setattr(tk1, "_scratch", {})
    seen = {}
    for n in [256, 512, 1024, 2000, 8192, 256, 512] + list(range(300, 330)):
        m = 8
        args = [torch.zeros((n, 128)), torch.zeros((m, 128)),
                torch.ones(n, dtype=torch.bool), torch.ones(m, dtype=torch.bool),
                torch.zeros((n, 2)), torch.zeros((m, 2)), torch.ones(n),
                torch.zeros(n, dtype=torch.int32), torch.zeros(m, dtype=torch.int32)]
        _, scratch = tk1._launch(tuple(args), (-1.0, 1.0))
        assert scratch.numel() == 64 * (n + 8)
        if n in seen and (None, 7, n, 8) in tk1._scratch:
            assert tk1._scratch[(None, 7, n, 8)] is scratch
        seen[n] = scratch
        assert len(tk1._scratch) <= 17
    assert len(calls) == 37
