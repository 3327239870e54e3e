"""Parity of the port's camera layer with the JAX package on the same numpy
inputs: geometry/camera.py, geometry/camera_models.py,
extractor.with_undistortion and the renderer's radtan lens.

Bars: 1e-5 relative-or-absolute (``rtol = atol = 1e-5``; a pixel near 500
holds one f32 ulp of 3e-5, so the relative part carries pixel coordinates)
for every camera function, the equidistant, fisheye and unified models
too.  ``with_undistortion``: 1e-5 relative and two f32 ulps at 256-512 px
(6.1e-5) absolute, measured 3.4e-5 on one coordinate near 0 px: the JAX
wrapper compiles the camera in as constants, and XLA divides by a constant
as a multiply by its reciprocal.  The lens renderer: frames equal to 1e-6 on all but the pixels whose ray lands on a
texture block edge (the undistorted ray differs in its last bit), measured
23 of 76 800 (0.03%) on one frame at 320x240 and none on the other three;
the bar is 0.1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asdslam_tpu.frontend import extractor as jext
from asdslam_tpu.geometry import camera as jcam
from asdslam_tpu.geometry import camera_models as jcm
from asdslam_tpu.io import synthetic as jsyn
from asdslam_torch.frontend import extractor as text
from asdslam_torch.geometry import camera as tcam
from asdslam_torch.geometry import camera_models as tcm
from asdslam_torch.io import synthetic as tsyn

TOL = 1e-5
# EuRoC's cam0 (tests/test_geometry.py:102-103), and a tangential-heavy lens
EUROC = (458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359,
         1.76187114e-05)
LENSES = {"euroc": EUROC, "tangential": (300.0, 310.0, 160.0, 120.0, -0.1, 0.02, 0.004,
                                         -0.003), "pinhole": (700.0, 700.0, 600.0, 180.0)}


def close(j, t, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def cams(name):
    return jcam.Camera.create(*LENSES[name]), tcam.Camera.create(*LENSES[name], device="cpu")


def pixels(seed, n=512):
    g = np.random.default_rng(seed)
    return (g.uniform(0, 1, (n, 2)) * np.float32([752, 480])).astype(np.float32)


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_camera_functions(lens):
    jc, tc = cams(lens)
    close(jc.K, tc.K)
    uv = pixels(1)
    xn = np.asarray(jcam.pixel_to_normalized(jc, jnp.asarray(uv)))
    close(jcam.pixel_to_normalized(jc, jnp.asarray(uv)), tcam.pixel_to_normalized(tc, torch.tensor(uv)))
    close(jcam.normalized_to_pixel(jc, jnp.asarray(xn)),
          tcam.normalized_to_pixel(tc, torch.tensor(xn)))
    close(jcam.distort_normalized(jc, jnp.asarray(xn)),
          tcam.distort_normalized(tc, torch.tensor(xn)))
    for iters in (8, 20):
        close(jcam.undistort_normalized(jc, jnp.asarray(xn), iters),
              tcam.undistort_normalized(tc, torch.tensor(xn), iters))
    close(jcam.undistort_points(jc, jnp.asarray(uv)), tcam.undistort_points(tc, torch.tensor(uv)))
    depth = np.random.default_rng(2).uniform(0.5, 30.0, len(uv)).astype(np.float32)
    X = np.array(jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(depth)))
    close(X, tcam.backproject(tc, torch.tensor(uv), torch.tensor(depth)))
    X[:3, 2] = [0.0, 1e-12, -1e-12]  # the near-zero depth guard
    close(jcam.project(jc, jnp.asarray(X)), tcam.project(tc, torch.tensor(X)))


@pytest.mark.parametrize("lens", ["euroc", "pinhole"])
def test_undistort_image_and_bilinear(lens):
    jc = jcam.Camera.create(*LENSES[lens][:2], 32.0, 24.0, *LENSES[lens][4:])
    tc = tcam.Camera.create(*LENSES[lens][:2], 32.0, 24.0, *LENSES[lens][4:], device="cpu")
    jc = jc._replace(fx=jnp.float32(60.0), fy=jnp.float32(58.0))
    tc = tc._replace(fx=torch.tensor(60.0), fy=torch.tensor(58.0))
    img = np.random.default_rng(3).uniform(size=(48, 64)).astype(np.float32)
    close(jcam.undistort_image(jc, jnp.asarray(img)), tcam.undistort_image(tc, torch.tensor(img)))
    # off the grid, on it, and clamped beyond every border
    uv = np.concatenate([pixels(4, 256) * np.float32([64 / 752, 48 / 480]),
                         np.float32([[0, 0], [63, 47], [-5, 3], [70, 50], [12, -1]])])
    close(jcam.bilinear_sample(jnp.asarray(img), jnp.asarray(uv)),
          tcam.bilinear_sample(torch.tensor(img), torch.tensor(uv)))


def test_camera_models():
    g = np.random.default_rng(5)
    xn = g.uniform(-0.8, 0.8, (300, 2)).astype(np.float32)
    xn[:2] = [[0.0, 0.0], [1e-9, 0.0]]  # the centre branch of every model
    params = dict(k1=-0.01, k2=0.003, k3=-0.002, k4=0.0005)
    jd = jcm.EquidistantDistortion.create(**params)
    td = tcm.EquidistantDistortion.create(**params, device="cpu")
    close(jcm.equidistant_distort(jd, jnp.asarray(xn)), tcm.equidistant_distort(td, torch.tensor(xn)))
    xd = np.asarray(jcm.equidistant_distort(jd, jnp.asarray(xn)))
    for iters in (8, 10):
        close(jcm.equidistant_undistort(jd, jnp.asarray(xd), iters),
              tcm.equidistant_undistort(td, torch.tensor(xd), iters))
    jf, tf = jcm.FisheyeDistortion.create(w=0.9), tcm.FisheyeDistortion.create(w=0.9, device="cpu")
    close(jcm.fisheye_distort(jf, jnp.asarray(xn)), tcm.fisheye_distort(tf, torch.tensor(xn)))
    close(jcm.fisheye_undistort(jf, jnp.asarray(xd)), tcm.fisheye_undistort(tf, torch.tensor(xd)))
    ju = jcm.UnifiedCamera.create(xi=0.8, fx=300.0, fy=300.0, cx=320.0, cy=240.0)
    tu = tcm.UnifiedCamera.create(xi=0.8, fx=300.0, fy=300.0, cx=320.0, cy=240.0, device="cpu")
    pts = g.uniform(-1, 1, (200, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[0] = [0.0, 0.0, 0.0]  # the zero-denominator guard
    close(jcm.unified_project(ju, jnp.asarray(pts)), tcm.unified_project(tu, torch.tensor(pts)))
    uv = pixels(6, 200)
    close(jcm.unified_backproject(ju, jnp.asarray(uv)), tcm.unified_backproject(tu, torch.tensor(uv)))


def test_with_undistortion():
    """The wrapped extractors of both packages on the same features: uv_und
    is the radtan inverse on valid rows and uv elsewhere."""
    uv = pixels(7, 400)
    valid = np.random.default_rng(8).uniform(size=400) > 0.3
    fields = dict(level=np.zeros(400, np.int32), angle=np.zeros(400, np.float32),
                  score=np.zeros(400, np.float32), desc=np.zeros((400, 128), np.float32),
                  valid=valid)
    jfeat = jext.FrameFeatures(uv=jnp.asarray(uv), uv_und=jnp.asarray(uv),
                               **{k: jnp.asarray(v) for k, v in fields.items()})
    tfeat = text.FrameFeatures(uv=torch.tensor(uv), uv_und=torch.tensor(uv),
                               **{k: torch.tensor(v) for k, v in fields.items()})
    jc, tc = cams("euroc")
    jout = jext.with_undistortion(lambda image: jfeat, jc)(jnp.zeros((4, 4)))
    tout = text.with_undistortion(lambda image: tfeat, tc)(torch.zeros(4, 4))
    np.testing.assert_allclose(tout.uv_und.numpy(), np.asarray(jout.uv_und), rtol=TOL,
                               atol=2 * 2.0 ** -15)
    und = tout.uv_und.numpy()
    assert np.array_equal(und[~valid], uv[~valid])
    assert np.abs(und[valid] - uv[valid]).max() > 10.0  # the lens really moves them
    assert torch.equal(tout.uv, tfeat.uv) and torch.equal(tout.valid, tfeat.valid)


@pytest.mark.parametrize("dist", [(-0.28, 0.07, 0.0, 0.0), EUROC[4:]])
def test_render_frame_through_a_lens(dist):
    K = np.float32([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    poses = np.asarray(jsyn.make_trajectory(3, 0.25, 0.004))
    for i in (0, 2):
        jf = np.asarray(jsyn.render_frame(jnp.asarray(poses[i]), jnp.asarray(K), 240, 320,
                                          dist=tuple(dist)))
        tf = tsyn.render_frame(torch.tensor(poses[i]), torch.tensor(K), 240, 320,
                               dist=tuple(dist)).numpy()
        off = np.abs(jf - tf) > 1e-6
        assert off.mean() < 1e-3, (i, int(off.sum()))
        plain = tsyn.render_frame(torch.tensor(poses[i]), torch.tensor(K), 240, 320).numpy()
        assert np.abs(plain - tf).mean() > 0.01  # the lens changes the picture
