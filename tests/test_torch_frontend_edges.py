"""Twins of the edge cases of tests/test_frontend_ops.py on the port: FAST on
a flat image and on bright squares, the windowed and global searches,
duplicate resolution, and ASDNet's inference and train-mode forwards.  The
port's other parity tests compare these functions on real frames only.

The same numpy inputs go through both packages; each test makes the
reference test's asserts on the port's result and holds it to the JAX
result: FAST, the searches and the duplicate resolution exactly (equal
inputs give equal keypoints, tests/test_torch_extract.py); ASDNet's bf16
forward within tests/test_torch_extract.py's 2.72e-3, the f32 train-mode
forward and its batch statistics within test_torch_train.py's 1e-5.
"""

import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from asdslam_tpu.models import asdnet as jnet
from asdslam_tpu.ops import fast as jfast
from asdslam_tpu.ops import match as jmatch
from asdslam_torch.models import asdnet as tnet
from asdslam_torch.ops import fast as tfast
from asdslam_torch.ops import match as tmatch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train import jax_mask  # noqa: E402


def T(x):
    return torch.tensor(np.asarray(x))


def equal(j, t):
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def synth_corner_image(h=96, w=128):
    """Bright squares on a dark ground: their corners are FAST corners."""
    img = np.full((h, w), 0.2, np.float32)
    for cy, cx in [(30, 40), (30, 90), (70, 40), (70, 90)]:
        img[cy - 6:cy + 6, cx - 6:cx + 6] = 0.9
    return img


def detect_both(img, max_keypoints):
    kw = dict(threshold=0.1, min_threshold=0.05, max_keypoints=max_keypoints, border=8)
    j = jfast.detect_level(jnp.asarray(img), **kw)
    t = tfast.detect_level(T(img), **kw)
    equal(j, t)
    return t


def test_flat_image_no_corners():
    xy, score, valid = detect_both(np.full((64, 64), 0.5, np.float32), 32)
    assert not bool(valid.any())


def test_detects_square_corners():
    xy, score, valid = detect_both(synth_corner_image(), 64)
    xy = xy.numpy()[valid.numpy()]
    assert len(xy) >= 8  # 4 squares x 4 corners, at least partly found
    corners = np.array([(cx + dx, cy + dy) for cy, cx in [(30, 40), (30, 90), (70, 40), (70, 90)]
                        for dy in (-6, 5) for dx in (-6, 5)], float)
    for p in xy:
        d = np.min(np.linalg.norm(corners - p[None, :], axis=1))
        assert d <= 3.0, f"detection {p} far from any corner ({d})"


def test_window_restricts():
    a = b = np.ones((2, 8), np.float32)
    uv_a = np.array([[0.0, 0.0], [100.0, 100.0]], np.float32)
    uv_b = np.array([[95.0, 100.0], [0.0, 3.0]], np.float32)
    valid = np.ones(2, bool)
    kw = dict(radius=10.0, max_dist=1.0, ratio=1.0)
    j = jmatch.search_window(*map(jnp.asarray, (a, b, uv_a, uv_b, valid, valid)), **kw)
    idx, d, ok = tmatch.search_window(*map(T, (a, b, uv_a, uv_b, valid, valid)), **kw)
    equal(j, (idx, d, ok))
    assert idx.tolist() == [1, 0]
    assert bool(ok.all())


def test_global_match_identity():
    g = np.random.default_rng(2)
    a = g.standard_normal((32, 128)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    perm = g.permutation(32)
    b = (a[perm] + 0.01 * g.standard_normal((32, 128))).astype(np.float32)
    valid = np.ones(32, bool)
    kw = dict(max_dist=0.5, ratio=0.9)
    j = jmatch.search_global(*map(jnp.asarray, (a, b, valid, valid)), **kw)
    idx, d, ok = tmatch.search_global(*map(T, (a, b, valid, valid)), **kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(d.numpy(), np.asarray(j[1]), atol=1e-5)
    assert bool(ok.all())
    np.testing.assert_array_equal(idx.numpy(), np.argsort(perm))


def test_duplicate_resolution():
    """Two rows match one column: only the nearer row keeps it."""
    dist = np.array([[0.1, np.inf], [0.05, np.inf]], np.float32)
    jidx, jd, jok = jmatch.nn_match(jnp.asarray(dist), max_dist=1.0)
    jok = jmatch.resolve_duplicates(jidx, jd, jok, 2)
    idx, d, ok = tmatch.nn_match(T(dist), max_dist=1.0)
    ok = tmatch.resolve_duplicates(idx, d, ok, 2)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [False, True]


def test_output_shape_and_norm():
    """The inference forward (bf16, as on the main path) from init_params:
    [16, 128] unit descriptors, within 2.72e-3 of the JAX forward (measured
    1.15e-3)."""
    params = jnet.init_params(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).uniform(size=(16, 32, 32)).astype(np.float32)
    net = tnet.ASDNet()
    net.load_state_dict(tnet.params_from_jax(params))
    with torch.no_grad():
        d = net(T(x)).numpy()
    assert d.shape == (16, 128)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(d, np.asarray(jnet.apply(params, jnp.asarray(x))), atol=2.72e-3)


def test_train_mode_stats():
    """The train-mode forward with batch statistics (the JAX dropout mask
    replayed) and one running-statistics update: seven layers of statistics,
    the running means moved off zero, all within 1e-5 of the JAX ones
    (measured 1.2e-6 in the descriptors, 1.3e-7 in the statistics)."""
    params = jax.device_get(jnet.init_params(jax.random.PRNGKey(0)))
    x = np.random.default_rng(3).uniform(size=(8, 32, 32)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jd, jstats = jnet.apply(params, jnp.asarray(x), train=True, dropout_key=key,
                            batch_stats=True, compute_dtype=jnp.float32)
    jp2 = jnet.update_running_stats(params, jstats)
    model = tnet.ASDNetTrain(params)
    with torch.no_grad():
        d, stats = model(T(x), train=True, dropout_mask=jax_mask(key, 8))
    model.update_running_stats(stats)
    assert d.shape == (8, 128)
    assert len(stats[0]) == len(tnet.LAYERS)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)
    for i in range(len(tnet.LAYERS)):
        for name in ("bn_mean", "bn_var"):
            np.testing.assert_allclose(getattr(model, f"{name}{i}").numpy(),
                                       np.asarray(jp2[name][i]), atol=1e-5, rtol=1e-5)
    assert not np.allclose(model.bn_mean0.numpy(), 0.0)
