"""Twins of tests/test_reset_capacity.py on the port: the store's capacity
growth and ``clear``, and a ``System`` reinitialising after a reset.

Each store test makes the reference test's calls on both packages' stores
with the same numpy features and holds the port's store to the JAX one's
(every array equal, ``tests/test_torch_mapping.py::_assert_stores_equal``)
besides the reference test's own asserts.  The reset test runs both
``System``s over the same frames, the port replaying the JAX draws
(``tests/test_torch_system.py::replay_reference_draws``), so both score
the same RANSAC hypotheses.  With its own draws the port bootstraps here at
the same frames as the JAX package (frame 3, and frame 7 after the reset,
with 149 and 133 map points against the JAX package's 155 and 140).  Bars:
the keyframe counts equal at each stage; the map points within 6%, twice
the gap measured below (the packages' keypoints differ on ~1%, ROADMAP
Queue 3).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asdslam_tpu.config import SlamConfig as JConfig
from asdslam_tpu.frontend.extractor import FrameFeatures as JFeatures
from asdslam_tpu.io import synthetic as jsyn
from asdslam_tpu.mapping.map_store import MapStore as JStore
from asdslam_tpu.models import patch_descriptor as jpatch
from asdslam_tpu.system import System as JSystem
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.mapping.map_store import MapStore as TStore
from asdslam_torch.models import patch_descriptor as tpatch
from asdslam_torch.system import System as TSystem

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mapping import _assert_stores_equal, _fake_features, torch_features  # noqa: E402
from test_torch_system import replay_reference_draws  # noqa: E402

POINT_SHARE = 0.06


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose():
    p = np.zeros(7, np.float32)
    p[0] = 1.0
    return p


class Stores:
    """A JAX store and a port store built alike; every call goes to both
    and must return the same."""

    def __init__(self, seed=0, **kw):
        self.j, self.t = JStore(**kw), TStore(**kw)
        self.g = np.random.default_rng(seed)

    def add_keyframe(self, pose, frame_id):
        f = _fake_features(self.g, self.j.n_feat)
        a = self.j.add_keyframe(pose, frame_id, JFeatures(*map(jnp.asarray, f)))
        b = self.t.add_keyframe(pose, frame_id, torch_features(f))
        assert a == b
        return b

    def __getattr__(self, name):
        def both(*args):
            a, b = getattr(self.j, name)(*args), getattr(self.t, name)(*args)
            assert a == b
            return b
        return both

    def assert_equal(self):
        _assert_stores_equal(self.j, self.t)
        assert (self.j.max_kfs, self.j.max_pts, self.j.max_obs) == \
            (self.t.max_kfs, self.t.max_pts, self.t.max_obs)


class TestCapacityGrowth:
    def test_keyframe_growth(self):
        s = Stores(max_kfs=2, max_pts=8, n_feat=4, max_obs=4)
        for i in range(5):
            assert s.add_keyframe(_pose(), i) == i
        s.assert_equal()
        store = s.t
        assert store.max_kfs >= 5
        assert store.n_kf == 5
        assert store.kf_valid[:5].all()
        assert (store.kf_frame_id[:5] == np.arange(5)).all()
        assert not store.kf_valid[5:].any()
        assert (store.kf_mp[4] == -1).all()

    def test_map_point_growth(self):
        s = Stores(max_kfs=4, max_pts=3, n_feat=4, max_obs=4)
        k = s.add_keyframe(_pose(), 0)
        desc = s.g.random(128).astype(np.float32)
        for i in range(10):
            assert s.add_map_point([0.0, 0.0, float(i)], desc, k) == i
        s.assert_equal()
        store = s.t
        assert store.max_pts >= 10
        assert store.mp_valid[:10].all()
        assert store.mp_pos[7, 2] == 7.0
        assert not store.mp_valid[10:].any()

    def test_growth_preserves_observations(self):
        s = Stores(max_kfs=2, max_pts=2, n_feat=4, max_obs=4)
        k0 = s.add_keyframe(_pose(), 0)
        m0 = s.add_map_point([1.0, 2.0, 3.0], np.zeros(128), k0)
        s.add_observation(m0, k0, 1)
        for i in range(4):
            s.add_map_point([0.0, 0.0, 1.0], np.zeros(128), k0)
            s.add_keyframe(_pose(), i + 1)
        s.assert_equal()
        store = s.t
        assert store.kf_mp[k0, 1] == m0
        assert store.mp_obs_kf[m0, 0] == k0
        assert store.mp_n_obs[m0] == 1


class TestClearAndReset:
    def test_store_clear(self):
        s = Stores(max_kfs=4, max_pts=8, n_feat=4, max_obs=4)
        k = s.add_keyframe(_pose(), 0)
        m = s.add_map_point([0.0, 0.0, 1.0], np.zeros(128), k)
        s.add_observation(m, k, 0)
        s.clear()
        s.assert_equal()
        store = s.t
        assert store.n_kf == 0 and store.n_mp == 0
        assert not store.kf_valid.any() and not store.mp_valid.any()
        assert len(store.kf_features) == 0 and len(store.kf_host) == 0
        assert (store.kf_mp == -1).all()

    def test_failed_init_reinitializes_clean(self):
        """Both Systems to a successful init, a forced reset (as a bad init
        would), the map empty, then a second init on the clean store.
        Measured: 2 keyframes in both packages at each init; map points 155
        / 154 and 140 / 136 (JAX / port), 2.9% apart at most."""
        kw = dict(n_features=400, n_levels=4, image_width=320, image_height=240,
                  fx=260.0, fy=260.0, cx=160.0, cy=120.0, local_ba_max_points=2048,
                  local_ba_max_obs=8192, max_keyframes=32, max_map_points=8192)
        K = jnp.array([[kw["fx"], 0, kw["cx"]], [0, kw["fy"], kw["cy"]], [0, 0, 1.0]])
        frames, _ = jsyn.render_sequence(K, n_frames=8, height=kw["image_height"],
                                         width=kw["image_width"], step=0.25)
        frames = [np.array(f) for f in frames]
        jsys = JSystem(JConfig(**kw), descriptor_fn=jpatch.apply, do_loop_closing=True)
        tsys = TSystem(TConfig(**kw), descriptor_fn=tpatch.apply, do_loop_closing=True,
                       device="cpu")
        replay_reference_draws(tsys.tracker)

        def both_run(ids):
            for i in ids:
                jsys.track_monocular(jnp.asarray(frames[i]), i)
                tsys.track_monocular(frames[i], i)
            js, ts = jsys.stats(), tsys.stats()
            assert js["n_keyframes"] == ts["n_keyframes"] >= 2, (js, ts)
            assert abs(ts["n_map_points"] - js["n_map_points"]) <= \
                POINT_SHARE * js["n_map_points"], (js, ts)
            return ts

        both_run(range(4))
        jsys.tracker._reset()
        tsys.tracker._reset()
        s = tsys.stats()
        assert s["n_keyframes"] == 0 and s["n_map_points"] == 0
        assert tsys.loop_closer.db is None
        assert tsys.loop_closer.kf_bow == {}
        assert tsys.local_mapper.recent == []

        s = both_run(range(4, 8))
        assert s["n_map_points"] > 50, s


class TestObsGrowth:
    def test_observation_capacity_grows(self):
        s = Stores(max_kfs=64, max_pts=8, n_feat=4, max_obs=2)
        m = s.add_map_point([0.0, 0.0, 1.0], np.zeros(128), 0)
        for k in range(6):
            s.add_keyframe(_pose(), k)
            s.add_observation(m, k, 0)
        s.assert_equal()
        store = s.t
        assert store.mp_n_obs[m] == 6
        assert store.max_obs >= 6
        assert (store.mp_obs_kf[m, :6] == np.arange(6)).all()

    def test_replace_grows_obs(self):
        s = Stores(max_kfs=64, max_pts=8, n_feat=4, max_obs=2)
        a = s.add_map_point([0.0, 0.0, 1.0], np.zeros(128), 0)
        b = s.add_map_point([0.0, 0.0, 1.1], np.zeros(128), 0)
        for k in range(4):
            s.add_keyframe(_pose(), k)
        s.add_observation(a, 0, 0)
        s.add_observation(a, 1, 0)
        s.add_observation(b, 2, 0)
        s.add_observation(b, 3, 0)
        s.replace_map_point(b, a)   # a gains b's observations -> grow
        s.assert_equal()
        store = s.t
        assert store.mp_n_obs[a] == 4
        assert not store.mp_valid[b]
        assert store.kf_mp[2, 0] == a and store.kf_mp[3, 0] == a
