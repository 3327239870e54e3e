"""The map store's block refresh of distinctive descriptors
(``MapStore.compute_distinctive_descriptors``) against its one-point
version, bit for bit, on seeded stores: points of one to 32 observations,
chunks that split a group, unit-norm and raw descriptors, points without
observations left alone."""

import numpy as np
import pytest

from asdslam_torch.mapping import map_store
from asdslam_torch.mapping.map_store import HostFeat, MapStore


def _store(seed, max_obs, unit):
    g = np.random.default_rng(seed)
    n_kf, n_feat, n_pts = 24, 300, 1500
    store = MapStore(32, 2048, n_feat, 32)
    for _ in range(n_kf):
        d = g.standard_normal((n_feat, 128)).astype(np.float32)
        if unit:
            d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        store.kf_host.append(HostFeat(np.zeros((n_feat, 2), np.float32),
                                      np.zeros(n_feat, np.int32), d, np.ones(n_feat, bool)))
    n_obs = g.integers(0, max_obs + 1, n_pts)
    for m, n in enumerate(n_obs):
        store.mp_n_obs[m] = n
        store.mp_obs_kf[m, :n] = g.choice(n_kf, n, replace=False)
        store.mp_obs_feat[m, :n] = g.integers(0, n_feat, n)
    store.mp_desc[:n_pts] = g.standard_normal((n_pts, 128)).astype(np.float32)
    return store, np.unique(g.integers(0, n_pts, 1200))


@pytest.mark.parametrize("seed,max_obs,unit,chunk", [
    (0, 4, True, None), (1, 12, False, None), (2, 24, True, None), (3, 6, True, 1 << 12),
])
def test_block_refresh_same_bits(monkeypatch, seed, max_obs, unit, chunk):
    if chunk is not None:  # chunks of a few points: groups split across chunks
        monkeypatch.setattr(map_store, "_DESC_CHUNK", chunk)
    store, mps = _store(seed, max_obs, unit)
    before = store.mp_desc.copy()
    for m in mps:
        store.compute_distinctive_descriptor(int(m))
    one = store.mp_desc.copy()
    store.mp_desc[:] = before
    store.compute_distinctive_descriptors(mps)
    assert one.tobytes() == store.mp_desc.tobytes()
    untouched = np.setdiff1d(np.arange(len(before)), mps[store.mp_n_obs[mps] > 0])
    assert np.array_equal(store.mp_desc[untouched], before[untouched])
    store.compute_distinctive_descriptors(np.zeros(0, np.int64))  # nothing to do
    assert one.tobytes() == store.mp_desc.tobytes()
