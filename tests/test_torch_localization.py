"""Localization mode on the port, on the CPU: twins of
tests/test_localization_mode.py's three tests with the reference's own
bars (map save -> load -> localization-only tracking; relocalization
acceptance; localization-mode map extension with prior-map provenance), a
map saved by the JAX ``System`` loaded into the port's localization
``System`` beside the JAX one, and the masked-NN search of a relocalization
held against the reference kernel (CPU) and against its plain version (on a
card).

The cross-package case replays the JAX draws (the vocabulary's fallback
picks from PRNGKey(11), the PnP keys): both packages then train a vocabulary
with the same words from the same file and relocalize on the same frames.
Bars: the same frames tracked; camera centres within 2e-3 (measured 8.4e-4:
~1% of the keypoints differ between the packages, ROADMAP Queue 3).

Run as a script it prints the JAX package's results on chip_smoke.py's
phase 7 (the KITTI shape, trained ASDNet; CPU, ~4 min), the yardsticks of
its bars:

    python tests/test_torch_localization.py --reference-phase7
"""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # as a script: the CPU backend, as tests/conftest.py sets it
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)

import jax
import jax.numpy as jnp

from asdslam_tpu.config import SlamConfig as JConfig
from asdslam_tpu.io import synthetic as jsyn
from asdslam_tpu.loop import vocab as jvocab
from asdslam_tpu.models import patch_descriptor as jpatch
from asdslam_tpu.ops import pallas_match
from asdslam_tpu.system import System as JSystem
from asdslam_tpu.utils import evaluate as jeval
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.io import synthetic as tsyn
from asdslam_torch.loop import vocab as tvocab
from asdslam_torch.models import patch_descriptor as tpatch
from asdslam_torch.ops import match as tmatch
from asdslam_torch.ops import masked_nn as tk1
from asdslam_torch.system import System as TSystem
from asdslam_torch.utils import evaluate as teval
from test_torch_loop import jax_rand_idx
from test_torch_system import replay_reference_draws

# tests/test_e2e_synthetic.py's small_config(): the config's default modes
SMALL = dict(n_features=600, n_levels=4, image_width=320, image_height=240,
             fx=260.0, fy=260.0, cx=160.0, cy=120.0, min_match_count=60,
             local_ba_max_points=2048, local_ba_max_obs=8192, max_keyframes=64,
             max_map_points=16384)
CENTRE_BAR = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render(cfg, n_frames, scene, step=0.25, turn=0.004):
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, poses = tsyn.render_sequence(K, n_frames, cfg.image_height, cfg.image_width,
                                         step=step, turn=turn, scene=scene, device="cpu")
    return frames, poses.numpy()


def port_system(cfg, **kw):
    return TSystem(cfg, descriptor_fn=tpatch.apply, device="cpu", **kw)


@pytest.fixture(scope="module")
def built_map(tmp_path_factory):
    """TestLocalizationMode's and TestRelocAcceptance's first half: a map
    built over 30 frames and saved."""
    cfg = TConfig(**SMALL)
    frames, poses = render(cfg, 30, tsyn.Scene(back_z=-8.0, front_z=20.0))
    sys1 = port_system(cfg)
    for i in range(30):
        sys1.track_monocular(frames[i], i)
    assert sys1.stats()["n_keyframes"] >= 2
    path = str(tmp_path_factory.mktemp("map") / "chamo.map")
    sys1.save_map(path)
    return cfg, frames, sys1, path


def test_save_load_localize(built_map):
    cfg, frames, sys1, path = built_map
    sys2 = port_system(cfg, localization_mode=True)
    sys2.load_map(path)
    n_kf = sys1.stats()["n_keyframes"]
    assert sys2.store.n_kf == n_kf
    assert sys2.loop_closer is not None and sys2.loop_closer.only_global_map
    assert sys2.loop_closer.vocab is not None and sys2.loop_closer.db is not None
    tracked = sum(sys2.track_monocular(frames[i], i) is not None for i in range(30))
    # no map growth in localization mode
    assert sys2.store.n_kf == n_kf
    assert tracked >= 15, tracked
    # the localized trajectory agrees with the mapping trajectory
    e1, e2 = teval.associate_by_id(teval.camera_centers(sys1.frame_trajectory()),
                                   teval.camera_centers(sys2.frame_trajectory()))
    err = np.linalg.norm(e1 - e2, axis=1)
    assert np.median(err) < 0.05, np.median(err)


def reloc_recorded(tracker, feat):
    """tracker._relocalize(feat), and the arguments of every projection
    search it made."""
    calls, real = [], tmatch.search_projection

    def recorder(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    tmatch.search_projection = recorder
    try:
        return tracker._relocalize(feat), calls
    finally:
        tmatch.search_projection = real


def k1_args(call):
    """The masked_nn arguments ``search_projection`` hands the kernel for
    these search arguments (ops/match.py)."""
    b = inspect.signature(tmatch.search_projection).bind(*call[0], **call[1])
    b.apply_defaults()
    a = b.arguments
    vb = a["valid_b"] if a["skip_b"] is None else a["valid_b"] & ~a["skip_b"]
    n = a["desc_a"].shape[0]
    r = torch.as_tensor(a["radius_a"], dtype=torch.float32).expand(n).contiguous()
    w = float(a["level_window"])
    lw = (-w, w) if a["pred_level_a"] is not None else (-1e9, 1e9)
    return (a["desc_a"].float(), a["desc_b"].float(), a["valid_a"], vb, a["uv_proj_a"],
            a["uv_b"], r * r, a["pred_level_a"], a["levels_b"], lw)


@pytest.fixture(scope="module")
def reloc_acceptance(built_map):
    """TestRelocAcceptance on the port: the rich map accepted with >= 50
    inliers, then a thin map (40 of one keyframe's points) rejected, with
    the widening searches that rejection runs recorded."""
    cfg, frames, _, path = built_map
    sys2 = port_system(cfg, localization_mode=True)
    sys2.load_map(path)
    tr = sys2.tracker
    feat = tr.extract(frames[5])
    rich, _ = reloc_recorded(tr, feat)
    rich_inliers = tr.n_inliers
    store = sys2.store
    kf_mp = store.kf_mp[0]
    keep = np.unique(kf_mp[kf_mp >= 0])
    keep = keep[store.mp_valid[keep]][:40]
    mask = np.zeros_like(store.mp_valid)
    mask[keep] = True
    store.mp_valid[:] = mask
    tr.n_inliers = 0
    thin, calls = reloc_recorded(tr, feat)
    return cfg, rich, rich_inliers, thin, calls


def test_thin_map_reloc_rejected_rich_map_accepted(reloc_acceptance):
    cfg, rich, rich_inliers, thin, calls = reloc_acceptance
    assert rich and rich_inliers >= cfg.reloc_min_inliers, rich_inliers
    assert not thin
    # the rejection ran the widening search (the projection search K1 serves)
    assert calls


def test_reloc_search_matches_reference_kernel(reloc_acceptance):
    """The relocalization's widening searches through the port's masked_nn
    (its plain version, on the CPU) and through the JAX package's Pallas
    kernel in interpret mode: ok and idx exact, best and second 1e-5."""
    calls = reloc_acceptance[4]
    for call in calls:
        args = k1_args(call)
        idx, best, second = tk1.masked_nn(*args)
        ja = [None if a is None else jnp.asarray(a.numpy()) for a in args[:9]]
        jidx, jbest, jsecond = (np.asarray(x) for x in pallas_match.masked_nn(
            *ja, args[9], interpret=True))
        ok = (best <= 1.2) & (best < 0.8 * second)
        np.testing.assert_array_equal(ok.numpy(), (jbest <= 1.2) & (jbest < 0.8 * jsecond))
        clear = (jsecond - jbest) > 1e-4
        np.testing.assert_array_equal(idx.numpy()[clear], jidx[clear])
        np.testing.assert_allclose(best.numpy(), jbest, rtol=0, atol=1e-5)
        np.testing.assert_allclose(second.numpy(), jsecond, rtol=0, atol=1e-5)
        assert (best < tk1.BIG).any()


@pytest.mark.gpu
def test_reloc_search_kernel_on_card(reloc_acceptance):
    """K1 against its plain version on a relocalization's recorded search:
    ok and idx exact, best within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for call in reloc_acceptance[4]:
        args = k1_args(call)
        cuda = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
        idx, best, second = (x.cpu() for x in tk1.masked_nn(*cuda))
        pidx, pbest, psecond = (x.cpu() for x in tk1.masked_nn_plain(*cuda))
        ok = (best <= 1.2) & (best < 0.8 * second)
        assert torch.equal(ok, (pbest <= 1.2) & (pbest < 0.8 * psecond))
        clear = (psecond - pbest) > 1e-4
        assert torch.equal(idx[clear], pidx[clear])
        assert float((best - pbest).abs().max()) <= 1e-6


def test_load_map_with_offline_vocabulary(built_map):
    """load_map in localization mode with an offline vocabulary (the JAX
    package's voc_patch_r04.npz) indexes the map's keyframes under it: the
    same bag-of-words vectors and database as the JAX package's on the same
    file."""
    path = built_map[3]
    voc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "voc_patch_r04.npz")
    jloc = JSystem(JConfig(**SMALL), descriptor_fn=jpatch.apply, localization_mode=True)
    tloc = port_system(TConfig(**SMALL), localization_mode=True)
    jloc.loop_closer.vocab = jvocab.load_vocab(voc)
    tloc.loop_closer.vocab = tvocab.load_vocab(voc, device="cpu")
    jloc.load_map(path)
    tloc.load_map(path)
    jlc, tlc = jloc.loop_closer, tloc.loop_closer
    assert sorted(tlc.kf_bow) == sorted(jlc.kf_bow) == list(range(tloc.store.n_kf))
    for k in jlc.kf_bow:
        np.testing.assert_allclose(tlc.kf_bow[k], jlc.kf_bow[k], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tlc.db.occ, jlc.db.occ)
    np.testing.assert_array_equal(tlc.db.present, jlc.db.present)


def test_build_save_reload_extend_relocalize(tmp_path):
    """TestLocExtendMap on the port: a map of the first 20 frames, reloaded
    with cfg.loc_extend_map and tracked over all 40; only new keyframes and
    points lack the prior-map flag; a third system relocalizes against the
    extended map's prior part; the trajectory's sim3 ATE."""
    cfg = TConfig(**SMALL).replace(loc_extend_map=True)
    frames, poses = render(cfg, 40, tsyn.Scene(back_z=-8.0, front_z=24.0))
    sys1 = port_system(cfg)
    for i in range(20):
        sys1.track_monocular(frames[i], i)
    assert sys1.stats()["n_keyframes"] >= 2
    path = str(tmp_path / "chamo.map")
    sys1.save_map(path)

    sys2 = port_system(cfg, localization_mode=True)
    sys2.load_map(path)
    n_loaded = sys2.store.n_kf
    assert bool(sys2.store.kf_global[:n_loaded].all())
    for i in range(40):
        sys2.track_monocular(frames[i], i)
    sys2.finish()
    store = sys2.store
    n_after = store.n_kf
    assert n_after > n_loaded, (n_after, n_loaded)
    assert bool(store.kf_global[:n_loaded].all())
    assert not store.kf_global[n_loaded:n_after].any()
    new_mp = store.mp_valid[:store.n_mp] & ~store.mp_global[:store.n_mp]
    assert new_mp.sum() > 50

    path2 = str(tmp_path / "extended.map")
    sys2.save_map(path2)
    sys3 = port_system(cfg, localization_mode=True)
    sys3.load_map(path2)
    tracked = sum(sys3.track_monocular(frames[i], i) is not None for i in range(20))
    assert tracked >= 10, tracked

    est = teval.camera_centers(sys2.frame_trajectory())
    gt = teval.camera_centers([(i, poses[i]) for i in range(40)])
    e, g = teval.associate_by_id(est, gt)
    assert len(e) >= 25
    ate = teval.ate_rmse(e, g, align="sim3")
    assert ate < 0.5, ate


def test_jax_map_into_port_localization(tmp_path):
    """A .map written by the JAX System (synchronous, 20 frames), loaded
    into a localization System of each package (the config's default
    modes) with the JAX draws replayed on the port; both track 12 frames."""
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    K = jnp.array([[jcfg.fx, 0, jcfg.cx], [0, jcfg.fy, jcfg.cy], [0, 0, 1.0]])
    frames, _ = jsyn.render_sequence(K, 20, 240, 320, step=0.25, turn=0.004,
                                     scene=jsyn.Scene(back_z=-8.0, front_z=20.0))
    frames = np.asarray(frames)
    sys1 = JSystem(jcfg.replace(pipelined_tracking=False, async_mapping=False),
                   descriptor_fn=jpatch.apply)
    for i in range(20):
        sys1.track_monocular(frames[i], i)
    path = str(tmp_path / "jax.map")
    sys1.save_map(path)

    jloc = JSystem(jcfg, descriptor_fn=jpatch.apply, localization_mode=True)
    jloc.load_map(path)
    tloc = port_system(tcfg, localization_mode=True)
    replay_reference_draws(tloc.tracker)
    tloc.loop_closer._vocab_draws = lambda n: jax_rand_idx(
        jax.random.PRNGKey(11), n, tcfg.vocab_branching, tcfg.vocab_depth)
    tloc.load_map(path)
    np.testing.assert_array_equal(tloc.store.kf_pose[:tloc.store.n_kf],
                                  jloc.store.kf_pose[:jloc.store.n_kf])
    jlc, tlc = jloc.loop_closer, tloc.loop_closer
    assert jlc.kf_bow.keys() == tlc.kf_bow.keys()
    for k in jlc.kf_bow:  # the same words from the same file
        np.testing.assert_array_equal(np.nonzero(tlc.kf_bow[k])[0], np.nonzero(jlc.kf_bow[k])[0])
    jt = [jloc.track_monocular(frames[i], i) is not None for i in range(12)]
    tt = [tloc.track_monocular(frames[i], i) is not None for i in range(12)]
    jloc.finish()
    tloc.finish()
    assert jt == tt and sum(tt) >= 8, (jt, tt)
    assert tloc.stats() == jloc.stats()
    a, b = teval.associate_by_id(teval.camera_centers(jloc.frame_trajectory()),
                                 teval.camera_centers(tloc.frame_trajectory()))
    assert len(a) == len(jloc.frame_trajectory()) >= 10
    assert np.linalg.norm(a - b, axis=1).max() < CENTRE_BAR


# --------------------------------------------------------------------------- #
# The yardsticks of chip_smoke.py's phase 7
# --------------------------------------------------------------------------- #
def reference_phase7():
    """The JAX package on phase 7's frames, on the CPU (the KITTI shape,
    trained ASDNet): (a) a synchronous map of 20 frames of the corridor,
    saved, then a localization System (the config's default modes) over the
    same 20 frames; (b) that map with loc_extend_map over frames 10-39;
    (c) EuRoC's lens at 752x480 over 20 frames, default configuration with
    loop closing.  Between (a) and (b), 7a's relocalization check: frame 5
    against the localization System's rich map and against a thin map of 40
    points, each candidate's rejecting stage recorded."""
    import pickle
    import tempfile
    import time
    import chip_smoke
    from asdslam_tpu.estimators import pnp as jpnp
    from asdslam_tpu.io import datasets as jdata
    from asdslam_tpu.ops import match as jmatch
    weights = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "asdnet_weights.pkl")
    with open(weights, "rb") as f:
        params = pickle.load(f)
    cfg = JConfig()
    K = jnp.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])

    def u8(frames):
        return np.clip(np.asarray(frames) * 255.0, 0, 255).astype(np.uint8)

    def ate(system, poses, first, last):
        est = jeval.camera_centers(system.frame_trajectory())
        gt = jeval.camera_centers([(i, poses[i]) for i in range(first, last)])
        e, g = jeval.associate_by_id(est, gt)
        return jeval.ate_rmse(e, g, align="sim3"), len(e)

    frames, poses = jsyn.render_sequence(K, 40, cfg.image_height, cfg.image_width,
                                         step=0.3, turn=0.004)
    frames, poses = u8(frames), np.asarray(poses)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "phase5.map")
    t0 = time.time()
    sync = JSystem(cfg.replace(pipelined_tracking=False, async_mapping=False),
                   asdnet_params=params)
    for i in range(20):
        sync.track_monocular(frames[i], i)
    sync.save_map(path)
    loc = JSystem(cfg, asdnet_params=params, localization_mode=True)
    loc.load_map(path)
    tracked = sum(loc.track_monocular(frames[i], i) is not None for i in range(20))
    loc.finish()
    e1, e2 = jeval.associate_by_id(jeval.camera_centers(sync.frame_trajectory()),
                                   jeval.camera_centers(loc.frame_trajectory()))
    med = float(np.median(np.linalg.norm(e1 - e2, axis=1)))
    print(f"7a JAX localization, CPU, {cfg.image_width}x{cfg.image_height}: map "
          f"{sync.stats()}, returned poses {tracked} of 20, {loc.stats()}, median camera-centre "
          f"distance to the mapping run {med:.6f} over {len(e1)} frames, "
          f"{time.time() - t0:.0f} s", flush=True)
    # 7a's relocalization check: frame 5 against the rich map, then against a
    # thin map of 40 of keyframe 0's points, each candidate's fate recorded
    tr, store = loc.tracker, loc.store
    feat = tr.extract(jnp.asarray(frames[5]).astype(jnp.float32) / 255.0)
    rich = chip_smoke.reloc_stages(tr, feat, jmatch, jpnp)
    kf_mp = store.kf_mp[0]
    keep = np.unique(kf_mp[kf_mp >= 0])
    keep = keep[store.mp_valid[keep]][:40]
    store.mp_valid[:] = np.isin(np.arange(len(store.mp_valid)), keep)
    tr.n_inliers = 0
    thin = chip_smoke.reloc_stages(tr, feat, jmatch, jpnp)
    print(f"7a JAX relocalization of frame 5, CPU: rich map {rich}; thin map of {len(keep)} "
          f"points {thin}", flush=True)

    t0 = time.time()
    ext = JSystem(cfg.replace(loc_extend_map=True), asdnet_params=params,
                  localization_mode=True)
    ext.load_map(path)
    n_loaded = ext.store.n_kf
    for i in range(10, 40):
        ext.track_monocular(frames[i], i)
    ext.finish()
    s = ext.store
    new_mp = int((s.mp_valid[:s.n_mp] & ~s.mp_global[:s.n_mp]).sum())
    a, n = ate(ext, poses, 10, 40)
    print(f"7b JAX loc_extend_map, CPU: keyframes {n_loaded} -> {s.n_kf}, new unflagged "
          f"points {new_mp}, {ext.stats()}, sim3 ATE {a:.6f} m over {n} frames, "
          f"{time.time() - t0:.0f} s", flush=True)

    t0 = time.time()
    cam = os.path.join(tmp, "euroc.txt")
    with open(cam, "w") as f:
        f.write("458.654,457.296,367.215,248.375,-0.28340811,0.07395907,0.00019359,"
                "1.76187114e-05\n")
    ecfg = jdata.config_from_cam_info(JConfig(), jdata.read_cam_info(cam), 752, 480)
    eK = jnp.array([[ecfg.fx, 0, ecfg.cx], [0, ecfg.fy, ecfg.cy], [0, 0, 1.0]])
    eframes, eposes = jsyn.render_sequence(eK, 20, 480, 752, step=0.3, turn=0.004,
                                           dist=tuple(ecfg.dist_coeffs))
    eframes, eposes = u8(eframes), np.asarray(eposes)
    lens = JSystem(ecfg, asdnet_params=params, do_loop_closing=True)
    tracked = sum(lens.track_monocular(eframes[i], i) is not None for i in range(20))
    lens.finish()
    a, n = ate(lens, eposes, 0, 20)
    print(f"7c JAX EuRoC lens, CPU, 752x480: returned poses {tracked} of 20, {lens.stats()}, "
          f"sim3 ATE {a:.6f} m over {n} frames, {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--reference-phase7"]:
        sys.exit(__doc__)
    reference_phase7()
