"""The port's proxy renderers (asdslam_torch/io/kitti_proxy.py,
io/euroc_proxy.py) against the JAX package's, on the CPU, and twins of
tests/test_euroc_proxy.py's three tests with its bars.

Bars: the trajectories, worlds, box selections and ray grids are numpy in
both packages and must be exactly equal; the texture hash keyed on a
per-pixel salt is bitwise equal to the reference's compiled one; a rendered
frame may differ from the reference's on at most 0.1% of its pixels by more
than 1e-5 (the bar of the lens renderer's test: float rounding in the ray
directions moves a few pixels across a texture-cell edge; measured
0.0006-0.003% at 752x480).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asdslam_tpu.io import euroc_proxy as jeu
from asdslam_tpu.io import kitti_proxy as jkp
from asdslam_tpu.io.synthetic import _hash01 as jhash
from asdslam_torch.config import SlamConfig
from asdslam_torch.io import euroc_proxy as teu
from asdslam_torch.io import kitti_proxy as tkp
from asdslam_torch.io.synthetic import _hash01 as thash
from asdslam_torch.models import patch_descriptor
from asdslam_torch.system import System
from asdslam_torch.utils import evaluate

PIXEL_SHARE_BAR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moved_share(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > 1e-5).mean())


def write_tum(path, n=120, seed=0):
    """A TUM file of a smooth drive with yaw, pitch and a little roll."""
    t = np.arange(n) * 0.1
    g = np.random.default_rng(seed)
    yaw, pitch, roll = 0.3 * np.sin(t / 3), 0.02 * np.sin(t), 0.01 * np.cos(t)
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    q = np.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                  cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], 1)  # w x y z
    pos = np.stack([np.cumsum(sy) * 1.1, 0.05 * g.normal(size=n).cumsum() * 0.1,
                    np.cumsum(cy) * 1.1], 1)
    with open(path, "w") as f:
        for i in range(n):
            f.write("%.6f %.9f %.9f %.9f %.9f %.9f %.9f %.9f\n" % (
                t[i], *pos[i], q[i, 1], q[i, 2], q[i, 3], q[i, 0]))


def test_trajectory_world_and_ray_grid_equal(tmp_path):
    jp, jc = jeu.mav_trajectory(300, loop_frames=250)
    tp, tc = teu.mav_trajectory(300, loop_frames=250)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)
    for a, b in zip(teu.build_hall(tc), jeu.build_hall(jc)):
        np.testing.assert_array_equal(a, b)
    args = (101, 67, 62.1, 61.9, 50.3, 33.2, jeu.EUROC_DIST)
    for a, b in zip(teu.distorted_ray_grid(*args), jeu.distorted_ray_grid(*args)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "gt.txt")
    write_tum(path)
    for a, b in zip(tkp.load_tum_trajectory(path), jkp.load_tum_trajectory(path)):
        np.testing.assert_array_equal(a, b)
    centers = tkp.load_tum_trajectory(path)[2]
    tw, jw = tkp.build_world(centers), jkp.build_world(centers)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    for k in (5, 40, len(tw.salt) + 7):   # k past the box count pads
        ours, ref = tkp.select_boxes(tw, centers[60], k), jkp.select_boxes(jw, centers[60], k)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_per_pixel_hash_bitwise():
    """The texture hash with one salt per pixel, as the box renderer keys
    it: every bit equal to the reference's compiled hash, over int32 cells
    and salts of both signs (both wrap as a uint32 cast does)."""
    g = np.random.default_rng(1)
    ix, iy, salt = (g.integers(-2 ** 31, 2 ** 31, size=(64, 80)).astype(np.int32)
                    for _ in range(3))
    ref = np.asarray(jax.jit(jhash)(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(salt)))
    out = thash(*(torch.from_numpy(a).to(torch.int64) for a in (ix, iy, salt))).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("depth", [False, True])
def test_render_boxes_against_reference(tmp_path, depth):
    """render_boxes (pinhole grid) on a street world at 124x38."""
    path = str(tmp_path / "gt.txt")
    write_tum(path)
    _, pose7, centers = tkp.load_tum_trajectory(path)
    world = tkp.build_world(centers)
    K = np.array([[71.8, 0, 60.7], [0, 71.8, 18.5], [0, 0, 1]], np.float32)
    for i in (0, 50, 110):
        w = tkp.select_boxes(world, centers[i], 64)
        ref = jkp.render_boxes(jnp.asarray(pose7[i]), jnp.asarray(K), jnp.asarray(w.bmin),
                               jnp.asarray(w.bmax), jnp.asarray(w.salt), 38, 124,
                               return_depth=depth)
        out = tkp.render_boxes(torch.from_numpy(pose7[i]), torch.from_numpy(K), w.bmin, w.bmax,
                               w.salt, 38, 124, return_depth=depth)
        if depth:
            (ref, ref_t), (out, out_t) = ref, out
            np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), rtol=1e-5)
        assert out.shape == (38, 124)
        assert moved_share(out, ref) <= PIXEL_SHARE_BAR


@pytest.mark.parametrize("boxes_per_chunk", [1, 3, 64])
def test_raycast_chunks_keep_the_first_box(tmp_path, monkeypatch, boxes_per_chunk):
    """raycast_grid splits the boxes into chunks: every split gives the same
    bits as one chunk, and a box listed twice with another salt loses to its
    first copy, within a chunk and across chunks, as the reference's scan."""
    path = str(tmp_path / "gt.txt")
    write_tum(path)
    _, pose7, centers = tkp.load_tum_trajectory(path)
    w = tkp.select_boxes(tkp.build_world(centers), centers[50], 32)
    bmin, bmax = np.concatenate([w.bmin, w.bmin]), np.concatenate([w.bmax, w.bmax])
    salt = np.concatenate([w.salt, w.salt + 7])
    v, u = torch.meshgrid(torch.arange(38.0), torch.arange(124.0), indexing="ij")
    xn, yn = (u - 60.7) / 71.8, (v - 18.5) / 71.8
    one = tkp.raycast_grid(pose7[50], xn, yn, bmin, bmax, salt, return_depth=True)
    first = tkp.raycast_grid(pose7[50], xn, yn, w.bmin, w.bmax, w.salt, return_depth=True)
    monkeypatch.setattr(tkp, "CHUNK_PAIRS", boxes_per_chunk * xn.numel())
    split = tkp.raycast_grid(pose7[50], xn, yn, bmin, bmax, salt, return_depth=True)
    for a, b, c in zip(split, one, first):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (one[1] < 1e8).float().mean() > 0.5     # most rays hit a box


def test_kitti_proxy_sequence(tmp_path, monkeypatch):
    """KittiProxySequence on a TUM file and a camera file the test writes."""
    for mod in (tkp, jkp):
        monkeypatch.setattr(mod, "GT_DIR", str(tmp_path))
        monkeypatch.setattr(mod, "CAM_DIR", str(tmp_path))
    os.makedirs(tmp_path / "nvidia_asnd_KITTI03")
    write_tum(tkp.gt_path("03"))
    with open(tkp.camera_config_path("03"), "w") as f:
        f.write("721.5377,721.5377,609.5593,172.854\n")
    tseq = tkp.KittiProxySequence("03", scale=0.1, n_boxes=48, max_frames=30, device="cpu")
    jseq = jkp.KittiProxySequence("03", scale=0.1, n_boxes=48, max_frames=30)
    assert len(tseq) == len(jseq) == 30
    np.testing.assert_array_equal(tseq.gt_pose7, jseq.gt_pose7)
    cfg = tseq.config(SlamConfig())
    assert (cfg.image_width, cfg.image_height) == (124, 38) and cfg.fx == jseq.fx
    for i in (0, 29):
        (ta, a), (tb, b) = tseq[i], jseq[i]
        assert ta == tb and a.device.type == "cpu"
        assert moved_share(a.numpy(), b) <= PIXEL_SHARE_BAR


def test_euroc_frames_against_reference():
    """EurocProxySequence frames at 0.25 scale, through the lens."""
    tseq = teu.EurocProxySequence(n_frames=1300, scale=0.25, device="cpu")
    jseq = jeu.EurocProxySequence(n_frames=1300, scale=0.25)
    assert (tseq.width, tseq.height) == (188, 120)
    for i in (0, 400, 1216):
        (ta, a), (tb, b) = tseq[i], jseq[i]
        assert ta == tb and a.shape == (120, 188)
        assert moved_share(a.numpy(), b) <= PIXEL_SHARE_BAR


# --------------------------------------------------------------------------- #
# twins of tests/test_euroc_proxy.py
# --------------------------------------------------------------------------- #
def test_trajectory_is_six_dof_and_closed():
    pose7, c = teu.mav_trajectory(1300, loop_frames=1200)
    step = np.linalg.norm(np.diff(c, axis=0), axis=1)
    assert 0.02 < step.mean() < 0.1          # MAV speed at 20 Hz
    # per-frame rotation well above KITTI's planar motion, not violent
    q = pose7[:, :4]
    dots = np.abs((q[1:] * q[:-1]).sum(1)).clip(-1, 1)
    ang = 2 * np.arccos(dots)
    assert 0.005 < ang.mean() < 0.05
    # genuinely 6-DoF: significant vertical travel and roll
    assert np.ptp(c[:, 1]) > 2.0
    # closed: the tail revisits the start region
    assert np.linalg.norm(c[1250] - c[50]) < 1.0


def test_rendered_distortion_matches_model():
    """A world point projected with the radtan forward model lands on the
    pixel that ray-casts to it: the rendered image carries the distortion."""
    xn, yn = teu.distorted_ray_grid(teu.EUROC_W, teu.EUROC_H, teu.EUROC_FX, teu.EUROC_FY,
                                    teu.EUROC_CX, teu.EUROC_CY, teu.EUROC_DIST)
    k1, k2, p1, p2 = teu.EUROC_DIST
    for (v, u) in [(10, 20), (240, 376), (400, 700), (30, 740)]:
        x, y = float(xn[v, u]), float(yn[v, u])
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        u_f = xd * teu.EUROC_FX + teu.EUROC_CX
        v_f = yd * teu.EUROC_FY + teu.EUROC_CY
        assert abs(u_f - u) < 0.05 and abs(v_f - v) < 0.05, (u, v, u_f, v_f)


def test_e2e_tracking_with_distortion():
    seq = teu.EurocProxySequence(n_frames=60, scale=0.4, device="cpu")
    cfg = seq.config(SlamConfig(
        n_features=600, n_levels=4, min_match_count=60,
        local_ba_max_points=2048, local_ba_max_obs=8192,
        max_keyframes=64, max_map_points=16384))
    assert cfg.has_distortion
    system = System(cfg, descriptor_fn=patch_descriptor.apply, device="cpu")
    for i in range(len(seq)):
        ts, img = seq[i]
        system.track_monocular(img, i)
    stats = system.stats()
    assert stats["n_frames_tracked"] >= 40, stats
    est = evaluate.camera_centers(system.frame_trajectory())
    gt = evaluate.camera_centers([(i, seq.gt_pose7[i]) for i in range(len(seq))])
    e, g = evaluate.associate_by_id(est, gt)
    ate = evaluate.ate_rmse(e, g, align="sim3")
    # ~2.8 m of path at 0.4 scale: sub-decimetre tracking expected
    assert ate < 0.15, ate
