"""Parity of the port's matchers (asdslam_torch.ops.match, ops.masked_nn)
with the JAX package on the same numpy inputs, and of the masked-NN CUDA
kernel with its plain version (on a CUDA device only).  Indices and masks
exact; distances 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asdslam_tpu.ops import match as jmatch
from asdslam_tpu.ops import pallas_match
from asdslam_torch.ops import masked_nn as tk1
from asdslam_torch.ops import match as tmatch


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


@pytest.mark.gpu
def test_masked_nn_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, n, m in ((7, 300, 257), (8, 2000, 2000)):
        p = _problem(seed, n=n, m=m)
        p["valid_a"][:40] = False
        args = [torch.tensor(p[k]).cuda() for k in
                ("desc_a", "desc_b", "valid_a", "valid_b", "uv_a", "uv_b")]
        args += [torch.tensor(p["radius"] ** 2).cuda(), torch.tensor(p["lvl_a"]).cuda(),
                 torch.tensor(p["lvl_b"]).cuda(), (-1.0, 1.0)]
        before = tk1.masked_nn.launches
        idx, best, second = tk1.masked_nn(*args)
        assert tk1.masked_nn.launches == before + 1
        pidx, pbest, psecond = tk1.masked_nn_plain(*args)
        torch.cuda.synchronize()
        clear = (psecond - pbest) > 1e-4
        assert torch.equal(idx[clear], pidx[clear])
        assert float((best - pbest).abs().max()) <= 5e-5
        assert float((second - psecond).abs().max()) <= 5e-5
