"""Parity of the port's extraction stages with the JAX package on the same
numpy inputs: pyramid and blur, FAST detection (tie order), orientation and
patches, ASDNet (stride-2 padding, folded BN, f32 and bf16), and the
synthetic renderer.  Tolerances: indices and masks exact; pyramid 1e-4;
ASDNet 1e-4 in f32 and 2e-2 in bf16."""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asdslam_tpu.geometry import se3 as jse3
from asdslam_tpu.io import synthetic as jsyn
from asdslam_tpu.models import asdnet as jnet
from asdslam_tpu.ops import fast as jfast
from asdslam_tpu.ops import patches as jpatches
from asdslam_tpu.ops import pyramid as jpyr
from asdslam_torch.io import synthetic as tsyn
from asdslam_torch.models import asdnet as tnet
from asdslam_torch.ops import fast as tfast
from asdslam_torch.ops import patches as tpatches
from asdslam_torch.ops import pyramid as tpyr

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "asdnet_weights.pkl")
K_SMALL = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def frame():
    """A synthetic corridor frame at 240x320, quantised to uint8 -> [0, 1]."""
    pose = jse3.pose_retract(jse3.pose_identity(),
                             jnp.array([0.0, 0.01, 0.0, 0.0, 0.0, -0.6]))
    img = np.asarray(jsyn.render_frame(pose, jnp.asarray(K_SMALL), 240, 320))
    return (np.clip(img * 255.0, 0, 255).astype(np.uint8).astype(np.float32) / 255.0)


def test_pyramid_and_blur(frame):
    lj = jpyr.build_pyramid(jnp.asarray(frame), 4, 1.2)
    lt = tpyr.build_pyramid(torch.tensor(frame), 4, 1.2)
    assert [tuple(x.shape) for x in lj] == [tuple(x.shape) for x in lt]
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.asarray(jpyr.gaussian_blur(a)),
                                   tpyr.gaussian_blur(torch.tensor(np.asarray(a))).numpy(),
                                   atol=1e-5, rtol=0)


def test_pyramid_antialiases():
    """The reference's linear resize antialiases when it downsamples; a plain
    bilinear resize would differ by far more than the tolerance."""
    g = np.random.default_rng(0)
    img = g.uniform(size=(376, 1241)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (313, 1034), "linear"))
    got = tpyr.resize(torch.tensor(img), (313, 1034)).numpy()
    np.testing.assert_allclose(ref, got, atol=1e-4, rtol=0)
    plain = torch.nn.functional.interpolate(
        torch.tensor(img)[None, None], size=(313, 1034), mode="bilinear",
        align_corners=False)[0, 0].numpy()
    assert np.abs(ref - plain).max() > 1e-2


@pytest.mark.parametrize("budget", [40, 217])
def test_detect_level_tie_order(frame, budget):
    """Level-0 input is exact on both sides, so every slot must agree,
    including the many zero-score slots whose order is the tie order."""
    img = frame.copy()
    img[:, 160:] = 0.5  # half the image flat: many cells with zero scores
    sj = np.asarray(jfast.nms3(jfast.fast_score(jnp.asarray(img))))
    st = tfast.nms3(tfast.fast_score(torch.tensor(img))).numpy()
    np.testing.assert_array_equal(sj, st)
    xj, scj, vj = jfast.detect_level(jnp.asarray(img), 20 / 255, 7 / 255, budget, 30, 4, 19)
    xt, sct, vt = tfast.detect_level(torch.tensor(img), 20 / 255, 7 / 255, budget, 30, 4, 19)
    assert (~np.asarray(vj)).sum() > 0 or budget == 40
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    np.testing.assert_array_equal(np.asarray(scj), sct.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_orientation_and_patches(frame):
    g = np.random.default_rng(1)
    xy = np.stack([g.integers(0, 320, 200), g.integers(0, 240, 200)], 1).astype(np.float32)
    aj = np.asarray(jpatches.ic_angle(jnp.asarray(frame), jnp.asarray(xy), radius=15))
    at = tpatches.ic_angle(torch.tensor(frame), torch.tensor(xy), radius=15).numpy()
    wrapped = np.angle(np.exp(1j * (aj.astype(np.float64) - at)))
    assert np.abs(wrapped).max() < 1e-4
    pj = np.asarray(jpatches.extract_patches(jnp.asarray(frame), jnp.asarray(xy), size=32))
    pt = tpatches.extract_patches(torch.tensor(frame), torch.tensor(xy), size=32).numpy()
    np.testing.assert_array_equal(pj, pt)


def _patches(seed, n=96):
    g = np.random.default_rng(seed)
    noise = g.uniform(size=(n, 32, 32))
    ramp = np.linspace(0, 1, 32)[None, None, :] * g.uniform(size=(n, 1, 1))
    return (0.5 * noise + 0.5 * ramp).astype(np.float32)


def _random_bn_params(seed):
    """init_params plus non-trivial BN statistics, so the folded BN is tested."""
    params = jnet.init_params(jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed)
    params["bn_mean"] = [jnp.asarray(g.normal(scale=0.1, size=m.shape), jnp.float32)
                         for m in params["bn_mean"]]
    params["bn_var"] = [jnp.asarray(g.uniform(0.5, 2.0, size=v.shape), jnp.float32)
                        for v in params["bn_var"]]
    return params


@pytest.mark.parametrize("source", ["init_params", "weights_file"])
def test_asdnet_f32(source):
    if source == "init_params":
        params = _random_bn_params(0)
        sd = tnet.params_from_jax(params)
    else:
        with open(WEIGHTS, "rb") as f:
            params = pickle.load(f)
        sd = tnet.load_weights(WEIGHTS)
    net = tnet.ASDNet()
    net.load_state_dict(sd)
    x = _patches(2)
    dj = np.asarray(jnet.apply(params, jnp.asarray(x), compute_dtype=jnp.float32))
    dt = net(torch.tensor(x), compute_dtype=torch.float32).detach().numpy()
    assert dt.shape == (x.shape[0], 128)
    np.testing.assert_allclose(dj, dt, atol=1e-4, rtol=0)


def test_asdnet_stride2_padding_is_0_1():
    """The reference's SAME padding on a stride-2 3x3 conv pads (0, 1); the
    port's layer must agree, and symmetric (1, 1) padding must not."""
    g = np.random.default_rng(5)
    x = g.normal(size=(4, 32, 32, 32)).astype(np.float32)
    w = g.normal(size=(3, 3, 32, 64)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    wt = torch.tensor(w).permute(3, 2, 0, 1)
    port = torch.nn.functional.conv2d(torch.nn.functional.pad(xt, (0, 1, 0, 1)), wt, stride=2)
    np.testing.assert_allclose(ref, port.permute(0, 2, 3, 1).numpy(), atol=1e-4, rtol=0)
    sym = torch.nn.functional.conv2d(xt, wt, stride=2, padding=1)
    assert np.abs(ref - sym.permute(0, 2, 3, 1).numpy()).max() > 1.0


def test_asdnet_bf16():
    with open(WEIGHTS, "rb") as f:
        params = pickle.load(f)
    net = tnet.ASDNet()
    net.load_state_dict(tnet.load_weights(WEIGHTS))
    x = _patches(3)
    dj = np.asarray(jnet.apply(params, jnp.asarray(x)))
    dt = net(torch.tensor(x)).detach().numpy()
    assert np.abs(dj - dt).max() <= 2e-2


def test_render_frame():
    poses = jsyn.make_trajectory(3, step=0.25, turn=0.004)
    tposes = tsyn.make_trajectory(3, step=0.25, turn=0.004, device="cpu")
    np.testing.assert_allclose(np.asarray(poses), tposes.numpy(), atol=1e-5, rtol=0)
    for i in range(3):
        fj = np.asarray(jsyn.render_frame(poses[i], jnp.asarray(K_SMALL), 240, 320))
        ft = tsyn.render_frame(torch.tensor(np.asarray(poses[i])),
                               torch.tensor(K_SMALL), 240, 320).numpy()
        qj = np.clip(fj * 255.0, 0, 255).astype(np.uint8)
        qt = np.clip(ft * 255.0, 0, 255).astype(np.uint8)
        assert (qj == qt).mean() >= 0.999
        assert np.abs(fj - ft).max() < 1.0  # edge pixels may land on another block
