"""The port's pipelined tracking and asynchronous mapping worker
(frontend/tracking.py), on the CPU: the twins of tests/test_pipelined.py's
four contracts, the engine's helpers against the JAX package's, the step's
device-side choice of the widened motion search, and the kernel wrapper's
bookkeeping driven from two threads.

The contracts, as the reference states them: two identical runs give
bit-identical trajectories and map statistics (the join fires at a fixed
frame offset, never when the worker happens to finish); quality stays in
the class of the synchronous mode; ``finish()`` delivers the deferred
frame; no worker is left running.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asdslam_tpu.frontend import tracking as jtracking
from asdslam_tpu.frontend import track_step as jts
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.frontend import track_step as tts
from asdslam_torch.frontend import tracking as ttracking
from asdslam_torch.geometry import se3 as tse3
from asdslam_torch.models import patch_descriptor as tpatch
from asdslam_torch.ops import masked_nn as tk1
from asdslam_torch.ops import match as tmatch
from asdslam_torch.system import System as TSystem
from asdslam_torch.utils import evaluate as teval

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mapping import SMALL, render_u8  # noqa: E402
from test_torch_track import K, STEP, TURN, _state, _to_torch, slice_setup  # noqa: E402,F401

N_FRAMES = 30


def small_config(**kw):
    cfg = dict(SMALL, **kw)
    return TConfig(**cfg)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The small shapes gain nothing from intra-op threads, and the test
    processes that run side by side would only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence():
    return render_u8(small_config(), N_FRAMES, step=0.25, turn=0.004)


def run(cfg, frames):
    system = TSystem(cfg, descriptor_fn=tpatch.apply, device="cpu")
    returned = 0
    for i in range(frames.shape[0]):
        if system.track_monocular(frames[i], i) is not None:
            returned += 1
    system.finish()
    return system, returned


@pytest.fixture(scope="module")
def runs(sequence):
    frames, _ = sequence
    pipe = small_config(pipelined_tracking=True, async_mapping=True)
    return dict(pipe=run(pipe, frames), again=run(pipe, frames),
                sync=run(small_config(), frames))


def ate_of(system, poses):
    est = teval.camera_centers(system.frame_trajectory())
    gt = teval.camera_centers([(i, poses[i]) for i in range(len(poses))])
    e, g = teval.associate_by_id(est, gt)
    return teval.ate_rmse(e, g, align="sim3"), len(e)


# --------------------------------------------------------------------------- #
# tests/test_pipelined.py's contracts
# --------------------------------------------------------------------------- #
def test_deterministic(runs):
    """Two identical pipelined + asynchronous runs agree exactly:
    trajectories, keyframe poses, map statistics and every store array."""
    (s1, r1), (s2, r2) = runs["pipe"], runs["again"]
    t1, t2 = s1.frame_trajectory(), s2.frame_trajectory()
    assert len(t1) == len(t2) > 0 and r1 == r2
    for (i1, p1), (i2, p2) in zip(t1, t2):
        assert i1 == i2
        np.testing.assert_array_equal(p1, p2)
    assert s1.stats() == s2.stats()
    for name in ("kf_pose", "kf_mp", "mp_pos", "mp_valid", "mp_found", "mp_visible"):
        np.testing.assert_array_equal(getattr(s1.store, name), getattr(s2.store, name))


def test_quality_matches_sync_mode(runs, sequence):
    """Tracking against the pre-keyframe map for up to mapping_overlap_frames
    does not change the quality class (the reference's bars: >= 15 frames
    tracked, sim3 ATE < 0.5 in both modes)."""
    _, poses = sequence
    ate_p, n_p = ate_of(runs["pipe"][0], poses)
    ate_s, n_s = ate_of(runs["sync"][0], poses)
    assert n_p >= 15 and n_s >= 15
    assert ate_p < 0.5, f"pipelined ATE {ate_p:.3f}"
    assert ate_s < 0.5, f"sync ATE {ate_s:.3f}"


def test_flush_drains_deferred_frame(runs, sequence):
    """The last frame's pose is deferred in pipelined mode; finish()
    delivers it, and it is idempotent."""
    frames, _ = sequence
    system, returned = runs["pipe"]
    traj_ids = [i for i, _ in system.frame_trajectory()]
    assert frames.shape[0] - 1 in traj_ids
    assert len(traj_ids) >= frames.shape[0] * 0.6
    assert returned < len(traj_ids)  # at least the last pose came from finish()
    system.finish()
    assert len(system.frame_trajectory()) == len(traj_ids)


def test_no_worker_left_running(runs):
    system, _ = runs["pipe"]
    assert system.tracker._map_thread is None
    assert system.tracker._pend is None
    assert not any(t.name == "asdslam-mapping" and t.is_alive() for t in threading.enumerate())


def test_worker_exception_is_raised_at_join(sequence):
    """An exception inside the mapping worker surfaces at the join."""
    frames, _ = sequence
    system = TSystem(small_config(pipelined_tracking=True, async_mapping=True),
                     descriptor_fn=tpatch.apply, device="cpu")

    def broken(kf):
        raise RuntimeError(f"worker failed on keyframe {kf}")

    system.local_mapper.process_phase_b = broken
    with pytest.raises(RuntimeError, match="worker failed"):
        for i in range(frames.shape[0]):
            system.track_monocular(frames[i], i)
        system.finish()
    assert system.tracker._map_thread is None


# --------------------------------------------------------------------------- #
# The engine's helpers against the JAX package's
# --------------------------------------------------------------------------- #
def test_remap_crow():
    g = np.random.default_rng(0)
    crow = g.integers(-1, 64, 200).astype(np.int32)
    remap = g.integers(-1, 80, 64).astype(np.int32)
    want = np.asarray(jtracking._remap_crow(jnp.asarray(crow), jnp.asarray(remap)))
    got = ttracking._remap_crow(torch.tensor(crow), torch.tensor(remap))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relpose_delta_and_apply(seed):
    """_relpose_delta and both appliers: 1e-6 (host f32 arithmetic on both
    sides), None for a negligible adjustment as in the reference."""
    g = np.random.default_rng(seed)

    def pose():
        R, t = tse3.se3_exp(torch.tensor(g.normal(0, 0.3, 6), dtype=torch.float32))
        return tse3.pose_pack(R, t).numpy()
    p0, p1, cur = pose(), pose(), pose()
    dj, dt = jtracking._relpose_delta(p0, p1), ttracking._relpose_delta(p0, p1)
    np.testing.assert_allclose(dt, dj, atol=1e-6)
    assert ttracking._relpose_delta(p0, p0.copy()) is None is jtracking._relpose_delta(p0, p0)
    np.testing.assert_allclose(ttracking._apply_delta_host(cur, dt),
                               jtracking._apply_delta_host(cur, dj), atol=1e-6)
    np.testing.assert_allclose(
        ttracking._apply_delta_dev(torch.tensor(cur), torch.tensor(dt)).numpy(),
        np.asarray(jtracking._apply_delta_dev(jnp.asarray(cur), jnp.asarray(dj))), atol=1e-6)


# --------------------------------------------------------------------------- #
# The step's widened motion search, chosen on the device
# --------------------------------------------------------------------------- #
def test_wide_radius_chosen_on_device(slice_setup):
    """A frame whose velocity is off by ~20 px, with min_motion_matches set
    between what the two radii find (the textures' repeats let the 15 px
    search still match ~220 features): the narrow search finds fewer, so
    the step keeps the 30 px search's result, as the reference's lax.cond
    does.  Same features on both sides: the same n_motion, src equal on
    >= 99.8%, poses within 1e-4."""
    s = slice_setup
    tcfg = s["tcfg"].replace(min_motion_matches=300)
    jstep = jts.make_track_step(s["jcfg"].replace(min_motion_matches=300), jnp.asarray(K),
                                lambda _img: ref["f"])
    ref = {}
    counts = []
    real = tmatch.search_projection

    def counted(*a, **kw):
        out = real(*a, **kw)
        counts.append(int(out[2].sum()))
        return out

    tstep = tts.make_track_step(tcfg, torch.tensor(K), lambda _img: _to_torch(ref["f"]),
                                device="cpu")
    (jf, jg, jp, _, jc), jcand, (tf, tg, tp, _, tc), tcand = _state(
        s, s["jf0"], _to_torch(s["jf0"]))
    off = tse3.pose_pack(*tse3.se3_exp(torch.tensor([0.0, TURN + 0.075, 0.0, 0.0, 0.0, -STEP])))
    img = s["frames_u8"][1]
    ref["f"] = s["jx"](jnp.asarray(img).astype(jnp.float32) / 255.0)
    jf1, jr = jstep(jnp.asarray(img), jp, jnp.asarray(off.numpy()), jf, jg, jcand, jc)
    tmatch.search_projection = counted
    try:
        tf1, tr = tstep(torch.tensor(img), tp, off, tf, tg, tcand, tc)
    finally:
        tmatch.search_projection = real
    narrow, wide = counts[0], counts[1]
    assert narrow < tcfg.min_motion_matches <= wide, counts
    assert int(tr.n_motion) == int(jr.n_motion) > narrow
    assert (np.asarray(jr.src) == tr.src.numpy()).mean() >= 0.998
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-4)


# --------------------------------------------------------------------------- #
# The kernel wrapper from two threads
# --------------------------------------------------------------------------- #
def test_wrapper_bookkeeping_from_two_threads(monkeypatch):
    """Two threads drive the wrapper's bookkeeping at once: the scratch
    table (``_scratch_buffer``, keyed by each thread's stream; a fake launch
    stands in for the kernel), the launch counter and the per-thread
    call-site labels.  No launch is lost, each thread's launches go to its
    own label, each thread keeps one buffer per shape, and the table stays
    bounded."""
    n_calls = 400
    seen = {}

    def fake_launch(args, level_window, scratch=None):
        stream = threading.get_ident()  # each thread as if on its own stream
        buf = tk1._scratch_buffer(torch.device("cpu"), stream, args[0].shape[0], 7,
                                  args[0].shape[1])
        seen.setdefault(stream, set()).add(buf.data_ptr())
        return (None, None, None), buf

    monkeypatch.setattr(tk1, "_launch", fake_launch)
    monkeypatch.setattr(tk1, "_layout", lambda n, m, d: (64, {}, 1))
    monkeypatch.setattr(tk1, "_scratch", {})
    monkeypatch.setattr(tk1.masked_nn, "launches", 0)
    monkeypatch.setattr(tk1.masked_nn, "by_site", {})
    a = torch.zeros((3, 128))

    class Cuda:  # the wrapper's device test on a CPU tensor, as on a card
        def __init__(self, t):
            self.t = t
            self.device = torch.device("cuda")
            self.shape = t.shape

    start = threading.Barrier(2)

    def worker(site):
        start.wait()
        with tk1.call_site(site):
            for _ in range(n_calls):
                tk1.masked_nn(Cuda(a), Cuda(a), None, None, a[:, :2], a[:, :2],
                              a[:, 0], a[:, 0], a[:, 0])

    monkeypatch.setattr(tk1, "_defaults", lambda *x: x[2:])
    threads = [threading.Thread(target=worker, args=(s,)) for s in ("tracker", "mapper")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tk1.masked_nn.launches == 2 * n_calls
    assert tk1.masked_nn.by_site == {"tracker": n_calls, "mapper": n_calls}
    assert len(seen) == 2 and all(len(ptrs) == 1 for ptrs in seen.values())
    assert len(tk1._scratch) == 2
    assert not set.intersection(*seen.values())  # the threads never share a buffer


def test_kernel_build_is_locked(monkeypatch):
    """Two threads at first use: the library is built once, in one pass
    with the other sources."""
    from asdslam_torch import kernels

    builds = []

    def fake_build(names):
        builds.append(list(names))
        threading.Event().wait(0.05)  # a slow build, so the threads overlap
        return {}

    monkeypatch.setattr(kernels, "_build", fake_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(kernels, "_loaded", {})
    out = []
    threads = [threading.Thread(target=lambda: out.append(kernels.load("masked_nn")))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert builds == [list(kernels.SOURCES)] and out[0] is out[1]


@pytest.mark.gpu
def test_kernel_from_two_threads_on_two_streams():
    """K1 launched from two threads, each on its own CUDA stream, each call
    held against the plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_match import _assert_k1_close, _k1_args, _problem

    probs = [_problem(s, n=900, m=700) for s in (21, 22)]
    results, errors = {}, []

    def worker(i):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                args = [None if x is None else x.cuda() for x in _k1_args(probs[i])]
                outs = [tk1.masked_nn(*args, (-1.0, 1.0)) for _ in range(20)]
                stream.synchronize()
            results[i] = ([o.cpu() for o in outs[-1]],
                          tk1.masked_nn(*[None if x is None else x.cpu() for x in args],
                                        (-1.0, 1.0)))
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for got, plain in results.values():
        _assert_k1_close(got, plain, 5e-5)
