"""The port's ``System`` as a whole, on the CPU: the end-to-end bars of
tests/test_e2e_synthetic.py on the port, parity with the JAX ``System`` in
the same synchronous configuration, one ``LocalMapper.process`` from a shared
state, the paths that wait, and run-to-run determinism.

Run as a script it prints the JAX package's result at the full KITTI shape,
the yardstick of chip_smoke.py's ATE bar:

    python tests/test_torch_system.py --reference-ate [STEP TURN N_FRAMES]
"""

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

from asdslam_tpu.utils import evaluate as jeval
from asdslam_torch.backend.local_mapping import LocalMapper as TLocalMapper
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.frontend.tracking import Tracker as TTracker
from asdslam_torch.loop.loop_closing import LoopCloser as TLoopCloser
from asdslam_torch.mapping.map_store import MapStore as TStore
from asdslam_torch.models import asdnet as tnet
from asdslam_torch.models import patch_descriptor as tpatch
from asdslam_torch.system import System as TSystem
from asdslam_torch.utils import evaluate as teval
from test_torch_mapping import SMALL, record_jax_run, render_u8, torch_store

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "asdnet_weights.pkl")
N_FRAMES = 30
# Measured between the two packages' frame trajectories over the 30 frames
# (patch descriptor; each map scaled to median depth 1 by its own bootstrap;
# the path is 0.517 long in those units): camera centres at most 0.0337 apart
# with no alignment -- it grows linearly with the distance travelled, i.e. it
# is the ~3% by which the two bootstraps' median depths differ, since ~1% of
# the keypoints differ between the packages -- and 0.0048 rmse after a sim3
# alignment.  The bars are those with 2x margin.
CENTRE_BAR = 0.068
ALIGNED_BAR = 0.0096


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These shapes are too small for intra-op threads to help, and the test
    processes that run side by side would only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence():
    """(config, uint8 frames, ground-truth poses): two frames more than the
    N_FRAMES the runs take, for the test that tracks on from their end."""
    cfg = TConfig(**SMALL)
    frames_u8, poses = render_u8(cfg, N_FRAMES + 2)
    return cfg, frames_u8, poses


def run_port(cfg, frames_u8, device="cpu", replay=False, **kw):
    system = TSystem(cfg, device=device, **kw)
    if replay:
        replay_reference_draws(system.tracker)
    tracked = [system.track_monocular(frames_u8[i], i) is not None
               for i in range(N_FRAMES)]
    return system, tracked


def replay_reference_draws(tracker):
    """Make the port's tracker draw what the reference's draws: its key
    sequence from PRNGKey(42), split once per two-view attempt and restarted
    when the tracker is rebuilt; PRNGKey(seed) for a PnP."""
    state = {}

    def draws(kind, iters, n, seed=None):
        if seed is not None:
            key = jax.random.PRNGKey(seed)
        else:
            if state.get("gen") is not tracker._gen:
                state["gen"], state["rng"] = tracker._gen, jax.random.PRNGKey(42)
            state["rng"], key = jax.random.split(state["rng"])
        return torch.tensor(np.asarray(jax.random.uniform(key, (iters, n)))).to(tracker.device)

    tracker._draws = draws


def centres(traj):
    return teval.camera_centers(traj)


def assert_e2e_bars(system, tracked, poses, need_points=True):
    stats = system.stats()
    n = len(tracked)
    assert stats["n_keyframes"] >= 2, stats
    if need_points:
        assert stats["n_map_points"] > 100, stats
    assert sum(tracked) >= n * 0.6, (sum(tracked), stats)
    est = centres(system.frame_trajectory())
    gt = centres([(i, poses[i]) for i in range(n)])
    e, g = teval.associate_by_id(est, gt)
    assert len(e) >= 15
    ate = teval.ate_rmse(e, g, align="sim3")
    assert ate < 0.5, f"ATE {ate:.3f} m"
    for _, pose in system.frame_trajectory():
        assert np.isfinite(pose).all()
    return ate


# --------------------------------------------------------------------------- #
# (a) the end-to-end bars, and (e) determinism
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_run(sequence):
    cfg, frames_u8, poses = sequence
    return run_port(cfg, frames_u8, descriptor_fn=tpatch.apply)


def test_full_slam_run(sequence, port_run):
    system, tracked = port_run
    assert_e2e_bars(system, tracked, sequence[2])
    # keyframes were inserted after the bootstrap, and the mapper ran on them
    assert system.stats()["n_keyframes"] >= 3
    assert system.local_mapper.last_pass["local_ba"]["finite"]
    assert "frame/fused_track/create_kf/mapping/local_ba/solve" in system.tracer.spans


def test_full_slam_with_trained_asdnet(sequence):
    cfg, frames_u8, poses = sequence
    system, tracked = run_port(cfg, frames_u8, asdnet_params=tnet.load_weights(WEIGHTS))
    assert_e2e_bars(system, tracked, poses, need_points=False)


def test_two_runs_bitwise_equal(sequence, port_run):
    cfg, frames_u8, _ = sequence
    again, tracked = run_port(cfg, frames_u8, descriptor_fn=tpatch.apply)
    first = port_run[0]
    assert tracked == port_run[1]
    for (fa, pa), (fb, pb) in zip(first.frame_trajectory(), again.frame_trajectory()):
        assert fa == fb and pa.tobytes() == pb.tobytes()
    for name in TStore.ARRAYS:
        assert getattr(first.store, name).tobytes() == getattr(again.store, name).tobytes(), name


@pytest.mark.gpu
def test_full_slam_run_on_cuda(sequence):
    """The twin of test_full_slam_run on the card, with the masked-NN kernel
    launched from the step and from the fuse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from asdslam_torch.ops import masked_nn as k1
    cfg, frames_u8, poses = sequence
    before = k1.masked_nn.launches
    system, tracked = run_port(cfg, frames_u8, device="cuda", descriptor_fn=tpatch.apply)
    assert_e2e_bars(system, tracked, poses)
    assert k1.masked_nn.launches > before + 2 * sum(tracked)


# --------------------------------------------------------------------------- #
# (b) parity with the JAX System, (c) one mapping pass from a shared state
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_run(sequence):
    return record_jax_run(sequence[1], N_FRAMES)


@pytest.fixture(scope="module")
def port_replay_run(sequence):
    """The port over the same frames, drawing what the reference draws."""
    cfg, frames_u8, _ = sequence
    return run_port(cfg, frames_u8, replay=True, descriptor_fn=tpatch.apply)


def test_parity_with_jax_system(jax_run, port_replay_run):
    jsys = jax_run["system"]
    tsys, tracked = port_replay_run
    assert tracked == jax_run["tracked"]
    js, ts = jsys.store, tsys.store
    # the bootstrap on the same frame pair, the same keyframes after it
    assert js.n_kf == ts.n_kf
    np.testing.assert_array_equal(js.kf_frame_id[:2], ts.kf_frame_id[:2])
    assert int(js.kf_valid.sum()) == int(ts.kf_valid.sum())
    # (which frame becomes a keyframe hangs on n_inliers < 60, and the ~1% of
    # keypoints that differ between the packages move that count by a few:
    # later keyframes may fall a frame apart)
    assert np.abs(js.kf_frame_id[:js.n_kf] - ts.kf_frame_id[:ts.n_kf]).max() <= 2
    assert abs(jsys.stats()["n_map_points"] - tsys.stats()["n_map_points"]) \
        <= 0.05 * jsys.stats()["n_map_points"]
    jc, tc = jeval.camera_centers(jsys.frame_trajectory()), centres(tsys.frame_trajectory())
    assert sorted(jc) == sorted(tc)
    worst = max(float(np.linalg.norm(jc[i] - tc[i])) for i in jc)
    ids = sorted(jc)
    aligned = teval.ate_rmse(np.array([tc[i] for i in ids]), np.array([jc[i] for i in ids]))
    path = float(np.linalg.norm(jc[ids[-1]] - jc[ids[0]]))
    print(f"worst camera-centre distance {worst:.6f}, sim3-aligned rmse {aligned:.6f}, "
          f"path {path:.4f}")
    assert worst < CENTRE_BAR, worst
    assert aligned < ALIGNED_BAR, aligned
    jr = jeval.camera_centers(jsys.frame_trajectory_recomposed())
    tr = centres(tsys.frame_trajectory_recomposed())
    assert sorted(jr) == sorted(tr)
    assert max(float(np.linalg.norm(jr[i] - tr[i])) for i in jr) < CENTRE_BAR


def test_local_mapper_pass_from_shared_state(sequence, jax_run):
    """``LocalMapper.process(kf)`` on a port store filled from the JAX store
    as it stood before the reference's own pass, held against the JAX store
    after it: keyframe poses and map points within 1e-3, the same points
    culled and created on >= 99%."""
    cfg = sequence[0]
    K = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]], np.float32)
    assert len(jax_run["passes"]) >= 3
    for p in jax_run["passes"][:3]:
        store = torch_store(p["before"])
        mapper = TLocalMapper(cfg, K, store, device="cpu")
        mapper.recent = list(p["recent"])
        mapper.process(p["kf"])
        after = p["after"]
        n_kf = after["n_kf"]
        assert store.n_kf == n_kf
        np.testing.assert_array_equal(store.kf_valid[:n_kf], after["kf_valid"][:n_kf])
        np.testing.assert_allclose(store.kf_pose[:n_kf], after["kf_pose"][:n_kf], atol=1e-3)
        np.testing.assert_array_equal(store.kf_parent[:n_kf], after["kf_parent"][:n_kf])
        # points: created in the same order when the verdicts agree
        n_mp = max(store.n_mp, after["n_mp"])
        assert abs(store.n_mp - after["n_mp"]) <= 0.01 * n_mp
        same = store.mp_valid[:n_mp] == after["mp_valid"][:n_mp]
        assert same.mean() >= 0.99, same.mean()
        created = after["n_mp"] - p["before"]["n_mp"]
        culled = int((p["before"]["mp_valid"] & ~after["mp_valid"]).sum())
        assert mapper.last_pass["new_points"] == pytest.approx(created, abs=0.01 * n_mp + 1)
        assert int((p["before"]["mp_valid"][:n_mp] & ~store.mp_valid[:n_mp]).sum()) \
            == pytest.approx(culled, abs=0.01 * n_mp + 1)
        both = store.mp_valid[:n_mp] & after["mp_valid"][:n_mp]
        old = both.copy()
        old[p["before"]["n_mp"]:] = False  # points both sides knew before the pass
        # within 1e-3 in the scene proper (median depth is 1); the few
        # runaway points that BA leaves at depth 10^2..10^3 are unconstrained
        # along their ray and differ by percents on both sides' own terms
        d = np.abs(store.mp_pos[:n_mp] - after["mp_pos"][:n_mp]).max(axis=1)
        near = old & (np.linalg.norm(after["mp_pos"][:n_mp], axis=1) < 5.0)
        assert near.sum() > 100 and d[near].max() < 1e-3, d[near].max()
        assert (d[old] < 1e-3).mean() >= 0.97  # measured 0.9805: 3 of 154 points
        bind = store.kf_mp[:n_kf] == after["kf_mp"][:n_kf]
        assert bind.mean() >= 0.99, bind.mean()


def test_staged_tracking_and_relocalization(sequence, jax_run, port_replay_run):
    """The paths behind the fused step, on both packages, continuing the two
    runs above past their end (this test changes them: it comes after the
    tests that read them): a frame tracked by the staged path (motion model,
    local map), then a frame after a forced loss (PnP relocalization against
    the last keyframes, the reference's key replayed)."""
    from asdslam_torch.frontend import tracking as ttracking
    cfg, frames_u8, _ = sequence
    n = N_FRAMES
    jsys, tsys = jax_run["system"], port_replay_run[0]
    calls = []
    for name, system in (("jax", jsys), ("torch", tsys)):
        tracker = system.tracker
        tracker._fused_eligible = lambda: False
        for method in ("_track_motion_model", "_track_local_map", "_relocalize"):
            def spy(*a, _real=getattr(tracker, method), _tag=(name, method)):
                out = _real(*a)
                calls.append(_tag + (bool(out),))
                return out
            setattr(tracker, method, spy)

    def both(i):
        pj, pt = jsys.track_monocular(frames_u8[i], i), tsys.track_monocular(frames_u8[i], i)
        assert pj is not None and pt is not None
        cj = jeval.camera_centers([(i, pj)])[i]
        ct = centres([(i, pt)])[i]
        assert np.linalg.norm(cj - ct) < CENTRE_BAR
        return pj, pt

    both(n)
    assert calls == [(side, m, True) for side in ("jax", "torch")
                     for m in ("_track_motion_model", "_track_local_map")]
    del calls[:]
    for system in (jsys, tsys):
        system.tracker.state = ttracking.LOST
        system.tracker.velocity = None
    both(n + 1)
    assert calls == [(side, m, True) for side in ("jax", "torch")
                     for m in ("_relocalize", "_track_local_map")]
    assert jsys.tracker.state == tsys.tracker.state == ttracking.OK
    assert jsys.tracker.n_inliers >= cfg.reloc_min_inliers <= tsys.tracker.n_inliers


# --------------------------------------------------------------------------- #
# (d) the paths that wait
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["orb", "mesh_global_ba"])
def test_unported_construction_raises(case):
    sync = TConfig(**SMALL)
    cfg, kw, match = {
        # the reference's own use_orb System fails: 256-wide descriptors in
        # its 128-wide store (asdslam_tpu/mapping/map_store.py:76, 202)
        "orb": (sync.replace(use_orb=True), {}, "map store is 128 wide.*ported as functions"),
        "mesh_global_ba": (sync.replace(n_devices=2), dict(do_loop_closing=True), "ROADMAP"),
    }[case]
    with pytest.raises(NotImplementedError, match=match):
        TSystem(cfg, device="cpu", **kw)


def test_both_stores_reject_orb_width():
    """Where the reference's use_orb System fails, and why the port's System
    refuses cfg.use_orb: both packages' MapStore keep 128-wide descriptors,
    so add_map_point of a 256-wide ORB descriptor raises in each, and a
    128-wide one goes in."""
    from asdslam_tpu.mapping.map_store import MapStore as JStore

    for Store in (JStore, TStore):
        store = Store(max_kfs=4, max_pts=8, n_feat=16)
        assert store.mp_desc.shape[1] == 128
        with pytest.raises(ValueError, match="could not broadcast"):
            store.add_map_point(np.zeros(3), np.full(256, 1.0 / 16, np.float32), 0)
        assert store.add_map_point(np.zeros(3), np.zeros(128, np.float32), 0) == 0


@pytest.mark.parametrize("case", ["pipelined", "async", "defaults", "loop_closing",
                                  "localization", "distortion"])
def test_ported_modes_construct(case):
    """The modes that are ported build: the config's defaults (pipelined
    tracking, asynchronous mapping), loop closing, whose closer the mapper
    runs and the tracker's relocalization reads, localization mode, which
    builds a closer restricted to the prior map, and a lens with distortion,
    whose extractor undistorts."""
    sync = TConfig(**SMALL)
    cfg, kw = {
        "pipelined": (sync.replace(pipelined_tracking=True), {}),
        "async": (sync.replace(async_mapping=True), {}),
        "defaults": (TConfig(), dict(do_loop_closing=True)),
        "loop_closing": (sync, dict(do_loop_closing=True)),
        "localization": (sync, dict(localization_mode=True)),
        "distortion": (sync.replace(dist_coeffs=(-0.28, 0.07, 0.0, 0.0)), {}),
    }[case]
    system = TSystem(cfg, descriptor_fn=tpatch.apply, device="cpu", **kw)
    assert system.tracker.cfg is cfg
    if kw:
        assert system.local_mapper.loop_closer is system.loop_closer is not None
        assert system.loop_closer.tracer is system.tracer
        assert system.loop_closer.only_global_map == (case == "localization")
    assert system.tracker.localization_only == (case == "localization")
    assert system.tracker._may_insert_kfs == (case != "localization")
    assert system.extract is system.tracker.extract
    feat = system.extract(torch.rand(cfg.image_height, cfg.image_width,
                                     generator=torch.Generator().manual_seed(0)))
    moved = (feat.uv_und != feat.uv).any(dim=1)
    assert bool(moved.any()) == (case == "distortion") and not moved[~feat.valid].any()
    assert system.tracker._map_stream is None  # a CUDA stream only on a card


@pytest.mark.parametrize("method,args", [("save_debug_image", ("x.png",))])
def test_unported_methods_raise(method, args):
    system = TSystem(TConfig(**SMALL), descriptor_fn=tpatch.apply, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(system, method)(*args)


@pytest.mark.parametrize("method", ["save_map", "load_map", "save_result"])
def test_ported_methods_run(method, tmp_path, port_run):
    """Persistence on the port (parity with the JAX package's files in
    tests/test_torch_persistence.py): a map saved, loaded into a fresh
    store, and dumped as text."""
    system = port_run[0]
    path, out = str(tmp_path / "x.map"), str(tmp_path / "out")
    system.save_map(path)
    assert os.path.getsize(path) > 0
    if method == "load_map":
        fresh = TSystem(TConfig(**SMALL), descriptor_fn=tpatch.apply, device="cpu")
        fresh.load_map(path)
        assert fresh.store.n_kf == system.stats()["n_keyframes"]
        assert fresh.store.kf_global[:fresh.store.n_kf].all()
        assert fresh.loop_closer is None  # SLAM mode builds no database at load
    elif method == "save_result":
        system.save_result(out)
        assert sorted(os.listdir(out)) == [n + ".txt" for n in
                                           ("desc", "kps", "posi", "track", "traj")]
        assert len(open(os.path.join(out, "traj.txt")).readlines()) == \
            system.stats()["n_keyframes"]


def test_tracker_and_mapper_refuse_what_waits():
    cfg = TConfig(**SMALL)
    store = TStore(4, 16, cfg.n_features)
    K = np.eye(3, dtype=np.float32)
    # what waits: the loop closer's multi-device global BA
    with pytest.raises(NotImplementedError):
        TLoopCloser(cfg.replace(n_devices=2), K, store, device="cpu")
    # what is ported builds: a localization tracker (no keyframes unless
    # the map may extend), the asynchronous tracker, a mapper with a loop
    # closer
    loc = TTracker(cfg, K, None, store, localization_only=True, device="cpu")
    assert loc.localization_only and not loc._may_insert_kfs
    assert TTracker(cfg.replace(loc_extend_map=True), K, None, store, localization_only=True,
                    device="cpu")._may_insert_kfs
    tracker = TTracker(cfg.replace(async_mapping=True, pipelined_tracking=True), K, None,
                       store, device="cpu")
    closer = object()
    assert TLocalMapper(cfg, K, store, loop_closer=closer, device="cpu").loop_closer is closer
    # with nothing pending and no worker, flush and join do nothing
    assert tracker.flush() is None and tracker._join_mapping() is None
    assert tracker._pend is None and tracker._map_thread is None


def test_config_keeps_the_reference_fields():
    import dataclasses
    from asdslam_tpu.config import SlamConfig as JConfig
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert j == t
    assert TConfig().pipelined_tracking and TConfig().async_mapping


def test_trajectory_export(tmp_path, port_run):
    system = port_run[0]
    system.save_trajectory_tum(str(tmp_path / "kf.txt"))
    system.save_frame_trajectory_tum(str(tmp_path / "frames.txt"))
    kf = np.loadtxt(tmp_path / "kf.txt")
    fr = np.loadtxt(tmp_path / "frames.txt")
    assert kf.shape == (system.stats()["n_keyframes"], 8)
    assert fr.shape == (len(system.frame_trajectory()), 8)
    np.testing.assert_allclose(np.linalg.norm(fr[:, 4:], axis=1), 1.0, atol=1e-5)
    info, proj, obs_uv, ok = system.debug_info()
    assert info["n_matches"] > 50 and info["mean_reproj_err"] < 2.0


def reference_ate(step=0.3, turn=0.004, n_frames=40):
    """The JAX System at the full KITTI shape (SlamConfig() defaults,
    synchronous, trained ASDNet) on the synthetic corridor, on the CPU."""
    import pickle
    import time
    from asdslam_tpu.config import SlamConfig as JConfig
    from asdslam_tpu.system import System as JSystem
    cfg = JConfig().replace(pipelined_tracking=False, async_mapping=False)
    frames_u8, poses = render_u8(cfg, n_frames, step=step, turn=turn)
    with open(WEIGHTS, "rb") as f:
        system = JSystem(cfg, asdnet_params=pickle.load(f))
    t0 = time.time()
    tracked = [system.track_monocular(frames_u8[i], i) is not None for i in range(n_frames)]
    est = jeval.camera_centers(system.frame_trajectory())
    gt = jeval.camera_centers([(i, poses[i]) for i in range(n_frames)])
    e, g = jeval.associate_by_id(est, gt)
    print(f"JAX System, CPU, {cfg.image_width}x{cfg.image_height}, {cfg.n_features} features, "
          f"step {step} m, yaw {turn} rad/frame: tracked {sum(tracked)} of {n_frames}, "
          f"{system.stats()}, sim3 ATE {jeval.ate_rmse(e, g, align='sim3'):.6f} m, "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    if sys.argv[1:2] != ["--reference-ate"]:
        sys.exit(__doc__)
    extra = sys.argv[2:]
    reference_ate(*(float(extra[0]), float(extra[1]), int(extra[2])) if extra else ())
