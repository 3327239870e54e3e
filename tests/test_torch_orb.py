"""Parity of the port's ORB path with the JAX package on the same numpy
inputs: the sampling pattern, the descriptor, bit packing, the rotated
patch sampler, the ORB extractor and three chained fused steps with it;
and the System's refusal of cfg.use_orb.

Bars, and why:
- ``_PATTERN``, ``apply`` and ``pack_bits`` are exact (integer tables,
  comparisons of the same floats, +-1/16).
- ``extract_rotated_patches``: 3e-5 absolute on a [0, 1] noise image
  (measured 1.35e-5; 27% of samples differ at all): the sample positions
  differ by about one ulp (cos and sin round differently in XLA's CPU code
  and torch's, and XLA contracts the rotation into multiply-adds), which at
  x ~ 160 px is 1.5e-5 px, times the image's gradient (up to 1 a px).
- The extractor: keypoints shared >= 98.5% by (uv, level), the bar of
  tests/test_torch_track.py (the pyramid's rounding, ROADMAP Queue 3;
  measured 98.6-99.3% over frames 0-3); on shared keypoints the descriptor
  bits agree on >= 99.9% (measured 99.999-100%): a bit flips only where the
  two samples of a test are equal to within the patches' rounding.
- The chained step: keypoints as above, src equal on >= 98% of shared
  features (measured 99.1-99.7%), n_inliers within 2% (measured 1%), poses
  within 5e-3 of each other (measured 1.0e-3 to 1.8e-3).

Run as a script it prints the JAX package's ORB fused step on
chip_smoke.py's phase 10b (the KITTI shape, SlamConfig() defaults, the
hand-built state of phase 3 with ORB descriptors, 8 chained corridor
frames; CPU, ~5 min), the yardstick of that phase's bars:

    python tests/test_torch_orb.py --reference-phase10
"""

import json
import os
import sys

if __name__ == "__main__":  # as a script: the CPU backend, as tests/conftest.py sets it
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asdslam_tpu.config import SlamConfig as JConfig
from asdslam_tpu.frontend import extractor as jext
from asdslam_tpu.frontend import track_step as jts
from asdslam_tpu.ops import orb as jorb
from asdslam_tpu.ops import patches as jpatches
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.frontend import extractor as text
from asdslam_torch.frontend import track_step as tts
from asdslam_torch.geometry import se3 as tse3
from asdslam_torch.io import synthetic as tsyn
from asdslam_torch.ops import orb as torb
from asdslam_torch.ops import patches as tpatches

# the small_config of tests/test_e2e_synthetic.py (tests/test_torch_mapping.py's SMALL)
SMALL = dict(n_features=600, n_levels=4, image_width=320, image_height=240,
             fx=260.0, fy=260.0, cx=160.0, cy=120.0, min_match_count=60,
             local_ba_max_points=2048, local_ba_max_obs=8192, max_keyframes=64,
             max_map_points=16384)
STEP, TURN, N_FRAMES = 0.3, 0.004, 4
ROTATED_BAR = 3e-5
KEYPOINT_BAR = 0.985
BIT_BAR = 0.999
POSE_BAR = 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patches(seed, n, levels=None):
    """[n, 32, 32] float32 patches in [0, 1]; with ``levels``, quantised to
    that many grey levels, so many tests compare equal samples."""
    g = np.random.default_rng(seed)
    p = g.uniform(size=(n, 32, 32)).astype(np.float32)
    if levels:
        p = (np.floor(p * levels) / levels).astype(np.float32)
    return p


# --------------------------------------------------------------------------- #
# ops/orb.py
# --------------------------------------------------------------------------- #
def test_pattern_is_the_reference_table():
    assert torb._PATTERN.dtype == jorb._PATTERN.dtype
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(torb._make_pattern(24), jorb._make_pattern(24))


@pytest.mark.parametrize("levels", [None, 4])
def test_apply_bitwise(levels):
    p = _patches(1, 64, levels)
    j = np.asarray(jorb.apply(jnp.asarray(p)))
    t = torb.apply(torch.tensor(p)).numpy()
    assert t.dtype == np.float32 and t.shape == (64, torb.ORB_DIM)
    np.testing.assert_array_equal(j, t)
    assert set(np.unique(t)) == {-1.0 / 16, 1.0 / 16}


def test_pack_bits_bytes():
    p = torch.tensor(_patches(2, 16))
    d = torb.apply(p)
    t = torb.pack_bits(d)
    assert t.dtype == np.uint8 and t.shape == (16, 32)
    np.testing.assert_array_equal(t, jorb.pack_bits(jnp.asarray(d.numpy())))
    np.testing.assert_array_equal(t, torb.pack_bits(d.numpy()))


# twins of tests/test_training.py::TestOrb
def test_shape_and_norm():
    d = torb.apply(torch.tensor(_patches(5, 8)))
    assert d.shape == (8, 256)
    np.testing.assert_allclose(torch.linalg.norm(d, dim=1).numpy(), 1.0, atol=1e-5)


def test_distance_maps_hamming():
    d = torb.apply(torch.tensor(_patches(6, 2)))
    bits = torb.pack_bits(d)
    ham = np.unpackbits(bits[0] ^ bits[1]).sum()
    l2sq = float(((d[0] - d[1]) ** 2).sum())
    assert abs(l2sq - 4.0 * ham / 256.0) < 1e-4


def test_brightness_invariance():
    p = torch.tensor(_patches(7, 4))
    np.testing.assert_array_equal(torb.apply(p).numpy(), torb.apply(p * 0.5 + 0.1).numpy())


# --------------------------------------------------------------------------- #
# ops/patches.py::extract_rotated_patches
# --------------------------------------------------------------------------- #
def test_rotated_patches_match_reference():
    """Keypoints all over a 120x160 image, the borders included (every
    sample clamps), angles over the full circle."""
    g = np.random.default_rng(3)
    img = g.uniform(size=(120, 160)).astype(np.float32)
    xy = np.stack([g.uniform(-5, 165, 200), g.uniform(-5, 125, 200)], 1).astype(np.float32)
    xy[:4] = [[0, 0], [159, 119], [0, 119], [80.5, 60.25]]
    ang = g.uniform(-np.pi, np.pi, 200).astype(np.float32)
    ang[:4] = [0.0, np.pi, -np.pi / 2, 1.0]
    j = np.asarray(jpatches.extract_rotated_patches(jnp.asarray(img), jnp.asarray(xy),
                                                    jnp.asarray(ang)))
    t = tpatches.extract_rotated_patches(torch.tensor(img), torch.tensor(xy), torch.tensor(ang))
    assert t.shape == (200, 32, 32)
    np.testing.assert_allclose(t.numpy(), j, atol=ROTATED_BAR, rtol=0)


# twins of tests/test_frontend_ops.py::test_rotated_patch_flip / _ramp
def test_rotated_patch_flip():
    img = torch.tensor(np.random.default_rng(1).uniform(size=(64, 64)).astype(np.float32))
    xy = torch.tensor([[32.0, 32.0]])
    p0 = tpatches.extract_rotated_patches(img, xy, torch.tensor([0.0]), size=16)
    ppi = tpatches.extract_rotated_patches(img, xy, torch.tensor([np.pi], dtype=torch.float32),
                                           size=16)
    np.testing.assert_allclose(ppi[0].numpy(), p0[0].numpy()[::-1, ::-1], atol=1e-4)


def test_rotated_patch_ramp():
    img = torch.arange(64, dtype=torch.float32)[None, :].repeat(64, 1)
    p = tpatches.extract_rotated_patches(img, torch.tensor([[32.0, 32.0]]), torch.tensor([0.0]),
                                         size=16)
    expect = 32.0 + (np.arange(16, dtype=np.float32) - 7.5)
    np.testing.assert_allclose(p[0, 0].numpy(), expect, atol=1e-4)


# --------------------------------------------------------------------------- #
# The ORB extractor and the fused step with it
# --------------------------------------------------------------------------- #
def _identity_map(jfeat, tfeat):
    """For each port feature slot, the reference slot holding the same
    keypoint (uv, level), or -1; and the share of the reference's valid
    keypoints that the port also found."""
    ref = {(float(u), float(v), int(lv)): i for i, ((u, v), lv, ok) in enumerate(
        zip(np.asarray(jfeat.uv), np.asarray(jfeat.level), np.asarray(jfeat.valid))) if ok}
    t2j = np.full(tfeat.uv.shape[0], -1)
    for i, ((u, v), lv, ok) in enumerate(zip(tfeat.uv.numpy(), tfeat.level.numpy(),
                                             tfeat.valid.numpy())):
        if ok:
            t2j[i] = ref.get((float(u), float(v), int(lv)), -1)
    return t2j, float((t2j >= 0).sum()) / max(len(ref), 1)


def _bit_agreement(jfeat, tfeat, t2j):
    common = t2j >= 0
    jb = np.asarray(jfeat.desc)[t2j[common]] > 0
    tb = tfeat.desc.numpy()[common] > 0
    return float((jb == tb).mean())


def _extractors(jcfg, tcfg):
    return (jext.make_extractor(jcfg, jorb.apply, rotate_patches=True),
            text.make_extractor(tcfg, torb.apply, rotate_patches=True))


@pytest.fixture(scope="module")
def orb_setup():
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    K = torch.tensor([[SMALL["fx"], 0, SMALL["cx"]], [0, SMALL["fy"], SMALL["cy"]], [0, 0, 1.0]])
    frames, poses = tsyn.render_sequence(K, N_FRAMES, 240, 320, step=STEP, turn=TURN,
                                         device="cpu")
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).numpy() for f in frames]
    jx, tx = _extractors(jcfg, tcfg)
    jf0 = jx(jnp.asarray(frames_u8[0]).astype(jnp.float32) / 255.0)
    tf0 = tx(torch.tensor(frames_u8[0]).to(torch.float32) / 255.0)
    return dict(jcfg=jcfg, tcfg=tcfg, K=K, frames_u8=frames_u8, poses=poses.numpy(),
                jx=jx, tx=tx, jf0=jf0, tf0=tf0)


def test_orb_extractor_matches_reference(orb_setup):
    """Frame 0 at 320x240: 256-wide +-1/16 descriptors, zero on invalid
    slots, keypoints shared and bits equal on shared keypoints (bars in the
    module docstring)."""
    s = orb_setup
    jf, tf = s["jf0"], s["tf0"]
    assert tf.desc.shape == (SMALL["n_features"], 256) and tf.desc.dtype == torch.float32
    valid = tf.valid.numpy()
    assert set(np.unique(np.abs(tf.desc.numpy()[valid]))) == {1.0 / 16}
    assert not tf.desc.numpy()[~valid].any()
    t2j, share = _identity_map(jf, tf)
    assert share >= KEYPOINT_BAR, f"keypoints shared {share}"
    agree = _bit_agreement(jf, tf, t2j)
    assert agree >= BIT_BAR, f"descriptor bits equal on {agree} of shared keypoints"


def _state(s):
    """Each side's frame-0 features and their map points, a candidate block
    of the reference's frame-0 features (as tests/test_torch_track.py)."""
    N, P = SMALL["n_features"], SMALL["local_ba_max_points"]

    def geom(uv, level, valid):
        return [x.numpy() for x in tsyn.map_points(
            tse3.pose_identity(device="cpu"), s["K"], torch.tensor(uv), torch.tensor(level),
            torch.tensor(valid), 1.2, SMALL["n_levels"])]

    jf0, tf0 = s["jf0"], s["tf0"]
    jg = geom(np.asarray(jf0.uv), np.asarray(jf0.level), np.asarray(jf0.valid))
    tg = geom(tf0.uv.numpy(), tf0.level.numpy(), tf0.valid.numpy())
    rows = np.nonzero(np.asarray(jf0.valid))[0][:P]

    def pad(x):
        out = np.zeros((P,) + x.shape[1:], x.dtype)
        out[:len(rows)] = x[rows]
        return out

    cand = [pad(x) for x in jg[:4]] + [pad(np.asarray(jf0.desc)), pad(jg[4])]
    vel = tse3.pose_pack(*tse3.se3_exp(torch.tensor([0.0, TURN, 0.0, 0.0, 0.0, -STEP]))).numpy()
    pose = np.float32([1, 0, 0, 0, 0, 0, 0])
    crow = np.full(N, -1, np.int32)
    jstate = (jf0, jts.GeomBlock(*map(jnp.asarray, jg)), jnp.asarray(pose), jnp.asarray(vel),
              jnp.asarray(crow))
    tstate = (tf0, tts.GeomBlock(*map(torch.tensor, tg)), torch.tensor(pose), torch.tensor(vel),
              torch.tensor(crow))
    return jstate, jts.PointBlock(*map(jnp.asarray, cand)), tstate, \
        tts.PointBlock(*map(torch.tensor, cand))


def test_orb_track_step_chain(orb_setup):
    """Three chained fused steps with the ORB extractor on both sides, each
    extracting its own features: keypoints shared, match sources equal,
    n_inliers within 2%, poses within 5e-3 of each other and near the
    ground truth."""
    s = orb_setup
    (jf, jg, jp, jv, jc), jcand, (tf, tg, tp, tv, tc), tcand = _state(s)
    prev_map, _ = _identity_map(jf, tf)
    N = SMALL["n_features"]
    jstep = jts.make_track_step(s["jcfg"], jnp.asarray(s["K"].numpy()), s["jx"])
    tstep = tts.make_track_step(s["tcfg"], s["K"], s["tx"], device="cpu")
    for i in range(1, N_FRAMES):
        img = s["frames_u8"][i]
        jf, jr = jstep(jnp.asarray(img), jp, jv, jf, jg, jcand, jc)
        tf, tr = tstep(torch.tensor(img), tp, tv, tf, tg, tcand, tc)
        t2j, share = _identity_map(jf, tf)
        assert share >= KEYPOINT_BAR, f"frame {i}: keypoints shared {share}"
        common = t2j >= 0
        tsrc = tr.src.numpy().copy()
        from_prev = (tsrc >= 0) & (tsrc < N)
        tsrc[from_prev] = prev_map[tsrc[from_prev]]  # the port's slots as the reference's
        src_eq = (np.asarray(jr.src)[t2j[common]] == tsrc[common]).mean()
        assert src_eq >= 0.98, f"frame {i}: src equal on {src_eq}"
        prev_map = t2j
        assert int(tr.n_inliers) >= s["tcfg"].min_localmap_matches
        assert abs(int(jr.n_inliers) - int(tr.n_inliers)) <= 0.02 * int(jr.n_inliers)
        dpose = float(np.abs(np.asarray(jr.pose) - tr.pose.numpy()).max())
        assert dpose <= POSE_BAR, f"frame {i}: poses differ by {dpose}"
        assert float(np.abs(s["poses"][i] - tr.pose.numpy()).max()) < 0.05
        jg, jp, jv, jc = jr.next_geom, jr.pose, jr.velocity, jr.crow
        tg, tp, tv, tc = tr.next_geom, tr.pose, tr.velocity, tr.crow


# --------------------------------------------------------------------------- #
# The System's refusal
# --------------------------------------------------------------------------- #
def test_run_slam_torch_use_orb_exits_with_the_refusal():
    """run_slam_torch.py --use_orb exits with the System's message: the
    reference's use_orb System fails on its 128-wide store."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import run_slam_torch
    from asdslam_torch.system import ORB_REFUSAL

    with pytest.raises(SystemExit) as info:
        run_slam_torch.main(["--use_orb", "--device", "cpu", "--n_frames", "2"])
    assert str(info.value) == f"run_slam_torch.py: {ORB_REFUSAL}"
    assert "not ported" not in ORB_REFUSAL and "map store is 128 wide" in ORB_REFUSAL


# --------------------------------------------------------------------------- #
# The yardstick of chip_smoke.py's phase 10b
# --------------------------------------------------------------------------- #
def reference_phase10():
    """The JAX package's ORB fused step on phase 10b's inputs: the corridor
    at the KITTI shape rendered by the port on the CPU, phase 3's hand-built
    state (frame 0's features and map points, a candidate block of the
    first six frames' features) with ORB descriptors, 8 chained frames."""
    import time
    torch.set_num_threads(4)
    cfg = TConfig()
    jcfg = JConfig()
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    n_chained, step_m, turn = 8, 0.3, 0.004
    frames, poses = tsyn.render_sequence(K, n_chained + 1, cfg.image_height, cfg.image_width,
                                         step=step_m, turn=turn, device="cpu")
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).numpy() for f in frames]
    jx = jext.make_extractor(jcfg, jorb.apply, rotate_patches=True)
    t0 = time.perf_counter()
    feats = [jx(jnp.asarray(f).astype(jnp.float32) / 255.0) for f in frames_u8[:6]]
    P = cfg.local_ba_max_points
    rows = []
    for i, f in enumerate(feats):
        uv, lvl, valid = (torch.tensor(np.asarray(x)) for x in (f.uv, f.level, f.valid))
        geo = tsyn.map_points(poses[i], K, uv, lvl, valid, cfg.scale_factor, cfg.n_levels)
        keep = valid.nonzero()[:, 0]
        rows.append([x[keep].numpy() for x in geo[:4]] + [np.asarray(f.desc)[keep.numpy()]])
    cand = [np.concatenate([r[j] for r in rows])[:P] for j in range(5)]
    if cand[0].shape[0] < P:
        raise SystemExit(f"candidate block has {cand[0].shape[0]} < {P} real rows")
    cand = jts.PointBlock(*map(jnp.asarray, cand[:4]), desc=jnp.asarray(cand[4]),
                          valid=jnp.ones(P, bool))
    f0 = feats[0]
    geom = jts.GeomBlock(*(jnp.asarray(x.numpy()) for x in tsyn.map_points(
        poses[0], K, *(torch.tensor(np.asarray(x)) for x in (f0.uv, f0.level, f0.valid)),
        cfg.scale_factor, cfg.n_levels)))
    vel = tse3.pose_pack(*tse3.se3_exp(torch.tensor([0.0, turn, 0.0, 0.0, 0.0, -step_m])))
    pose, vel = jnp.asarray(poses[0].numpy()), jnp.asarray(vel.numpy())
    crow = jnp.full((cfg.n_features,), -1, jnp.int32)
    step = jts.make_track_step(jcfg, jnp.asarray(K.numpy()), jx)
    feat, n_in, err = f0, [], []
    for i in range(1, n_chained + 1):
        feat, res = step(jnp.asarray(frames_u8[i]), pose, vel, feat, geom, cand, crow)
        geom, pose, vel, crow = res.next_geom, res.pose, res.velocity, res.crow
        n_in.append(int(res.n_inliers))
        err.append(float(np.abs(np.asarray(res.pose) - poses[i].numpy()).max()))
    print(json.dumps({"phase": "10b", "frames": n_chained, "n_inliers": n_in,
                      "max_pose_err": err, "valid_features_frame0": int(np.asarray(f0.valid).sum()),
                      "seconds": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    if sys.argv[1:] != ["--reference-phase10"]:
        sys.exit(__doc__)
    reference_phase10()
