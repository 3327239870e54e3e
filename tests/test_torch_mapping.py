"""Parity of the port's mapping layer with the JAX package's: the global and
epipolar searches, the per-keyframe device functions on a state recorded
from a JAX run, and the map store copy driven through the same calls.

Bars: search indices and masks exact on >= 99.5% of rows;
``triangulate_neighbors`` / ``fuse_pairs`` verdicts equal on >= 99.5%,
triangulated points within 1e-4 relative; every array of the store equal.

``record_jax_run`` and the state converters below are shared with
tests/test_torch_system.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asdslam_tpu.backend import mapping_kernels as jmk
from asdslam_tpu.config import SlamConfig as JConfig
from asdslam_tpu.frontend.extractor import FrameFeatures as JFeatures
from asdslam_tpu.geometry import se3 as jse3
from asdslam_tpu.io import synthetic as jsyn
from asdslam_tpu.mapping.map_store import MapStore as JStore
from asdslam_tpu.models import patch_descriptor as jpatch
from asdslam_tpu.ops import match as jmatch
from asdslam_tpu.system import System as JSystem
from asdslam_torch.backend import mapping_kernels as tmk
from asdslam_torch.frontend.extractor import FrameFeatures as TFeatures
from asdslam_torch.mapping.map_store import MapStore as TStore
from asdslam_torch.ops import match as tmatch

# the small_config of tests/test_e2e_synthetic.py, in synchronous mode
SMALL = dict(n_features=600, n_levels=4, image_width=320, image_height=240,
             fx=260.0, fy=260.0, cx=160.0, cy=120.0, min_match_count=60,
             local_ba_max_points=2048, local_ba_max_obs=8192, max_keyframes=64,
             max_map_points=16384, pipelined_tracking=False, async_mapping=False)


# --------------------------------------------------------------------------- #
# Shared: a recorded JAX run, and JAX-side state as port-side state
# --------------------------------------------------------------------------- #
def render_u8(cfg, n_frames, step=0.25, turn=0.004):
    """(uint8 frames [n, H, W] as numpy, ground-truth poses [n, 7])."""
    K = jnp.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, poses = jsyn.render_sequence(K, n_frames, cfg.image_height, cfg.image_width,
                                         step=step, turn=turn)
    return np.clip(np.asarray(frames) * 255.0, 0, 255).astype(np.uint8), np.asarray(poses)


def to_np(x):
    """Nested tuples/lists of arrays -> numpy."""
    if isinstance(x, (tuple, list)):
        return [to_np(v) for v in x]
    return np.asarray(x)


def snapshot(store):
    """Every array of a store (either package's), as copies."""
    snap = {name: np.array(getattr(store, name)) for name in TStore.ARRAYS}
    snap["n_kf"], snap["n_mp"] = store.n_kf, store.n_mp
    snap["kf_host"] = [tuple(np.array(a) for a in h) for h in store.kf_host]
    snap["kf_features"] = [tuple(np.asarray(a) for a in f) for f in store.kf_features]
    return snap


def torch_features(f):
    return TFeatures(*[torch.tensor(np.asarray(a)) for a in f])


def torch_store(snap):
    """A port store holding a JAX-side snapshot."""
    return TStore.from_arrays(snap, snap["n_kf"], snap["n_mp"], snap["kf_host"],
                              [torch_features(f) for f in snap["kf_features"]])


def record_jax_run(frames_u8, n_frames, descriptor_fn=jpatch.apply, asdnet_params=None):
    """Run the JAX System in synchronous mode over the frames, recording per
    keyframe the store before and after ``LocalMapper.process`` and the
    arguments and results of the two mapping device functions."""
    cfg = JConfig(**SMALL)
    kw = dict(asdnet_params=asdnet_params) if asdnet_params is not None else dict(
        descriptor_fn=descriptor_fn)
    system = JSystem(cfg, **kw)
    rec = dict(system=system, passes=[], triangulate=[], fuse=[], tracked=[])
    mapper = system.local_mapper
    real_process = mapper.process
    real_tri, real_fuse = jmk.triangulate_neighbors, jmk.fuse_pairs

    def process(kf):
        before = snapshot(system.store)
        recent = list(mapper.recent)
        real_process(kf)
        rec["passes"].append(dict(kf=kf, before=before, recent=recent,
                                  after=snapshot(system.store)))

    def tri(*a, **k):
        out = real_tri(*a, **k)
        rec["triangulate"].append((to_np(a), k, to_np(out)))
        return out

    def fuse(*a, **k):
        out = real_fuse(*a, **k)
        rec["fuse"].append((to_np(a), k, np.asarray(out)))
        return out

    mapper.process = process
    jmk.triangulate_neighbors, jmk.fuse_pairs = tri, fuse
    try:
        for i in range(n_frames):
            rec["tracked"].append(system.track_monocular(frames_u8[i], i) is not None)
    finally:
        jmk.triangulate_neighbors, jmk.fuse_pairs = real_tri, real_fuse
    return rec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These shapes are too small for intra-op threads to help, and the test
    processes that run side by side would only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    frames_u8, _ = render_u8(JConfig(**SMALL), 13)
    rec = record_jax_run(frames_u8, 13)
    assert len(rec["passes"]) >= 2 and rec["triangulate"] and rec["fuse"]
    return rec


# --------------------------------------------------------------------------- #
# The searches
# --------------------------------------------------------------------------- #
def _search_problem(seed, n=400, m=380):
    g = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    a = unit(g.standard_normal((n, 128)))
    b = unit(g.standard_normal((m, 128)))
    half = m // 2
    b[:half] = unit(a[:half] + 0.08 * g.standard_normal((half, 128)))
    b[half + 3] = b[5]       # a duplicate column: two rows want it
    a[half + 1] = a[7]       # two rows, one best column
    X = (g.uniform(-3, 3, (n, 3)) + np.array([0, 0, 8.0])).astype(np.float32)
    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]], np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2, t2 = (np.asarray(x) for x in jse3.se3_exp(
        jnp.asarray([0.01, -0.03, 0.02, 0.5, 0.02, 0.1], jnp.float32)))

    def proj(R, t, Xs):
        xc = Xs @ R.T + t
        return (xc[:, :2] / xc[:, 2:] * 260.0 + np.array([160.0, 120.0])).astype(np.float32)

    uv1 = proj(R1, t1, X)
    uv2 = g.uniform(0, 320, (m, 2)).astype(np.float32)
    uv2[:half] = proj(R2, t2, X[:half]) + 0.3 * g.standard_normal((half, 2)).astype(np.float32)
    valid1 = g.uniform(size=n) > 0.1
    valid2 = g.uniform(size=m) > 0.1
    inv_s2 = (1.0 / 1.44 ** g.integers(0, 4, m)).astype(np.float32)
    return dict(a=a, b=b, uv1=uv1, uv2=uv2, valid1=valid1, valid2=valid2, K=K,
                R1=R1, t1=t1, R2=R2, t2=t2, inv_s2=inv_s2)


def _assert_search_equal(j, t, frac=0.995):
    jidx, jd, jok = (np.asarray(x) for x in j)
    tidx, td, tok = (x.numpy() for x in t)
    assert (jok == tok).mean() >= frac
    both = jok & tok
    assert both.sum() > 50
    assert (jidx[both] == tidx[both]).mean() >= frac
    np.testing.assert_allclose(jd[both], td[both], atol=1e-5)


@pytest.mark.parametrize("ratio", [0.7, 1.0])
def test_search_global(ratio):
    p = _search_problem(1)
    j = jmatch.search_global(*map(jnp.asarray, (p["a"], p["b"], p["valid1"], p["valid2"])),
                             max_dist=1.0, ratio=ratio)
    t = tmatch.search_global(*map(torch.tensor, (p["a"], p["b"], p["valid1"], p["valid2"])),
                             max_dist=1.0, ratio=ratio)
    _assert_search_equal(j, t)


def test_search_triangulation_and_fundamental():
    p = _search_problem(2)
    pose = ("K", "R1", "t1", "R2", "t2")
    jF = jmatch.fundamental_from_poses(*[jnp.asarray(p[k]) for k in pose])
    tF = tmatch.fundamental_from_poses(*[torch.tensor(p[k]) for k in pose])
    np.testing.assert_allclose(np.asarray(jF), tF.numpy(), atol=1e-9, rtol=1e-4)
    keys = ("a", "b", "uv1", "uv2", "valid1", "valid2")
    jm = jmatch.epipolar_mask(jF, jnp.asarray(p["uv1"]), jnp.asarray(p["uv2"]),
                              jnp.asarray(p["inv_s2"]))
    # the same F on both sides from here: the mask and the search, not F's rounding
    F = torch.tensor(np.asarray(jF))
    tm = tmatch.epipolar_mask(F, torch.tensor(p["uv1"]), torch.tensor(p["uv2"]),
                              torch.tensor(p["inv_s2"]))
    assert (np.asarray(jm) == tm.numpy()).mean() >= 0.9999
    j = jmatch.search_triangulation(*[jnp.asarray(p[k]) for k in keys], jF,
                                    jnp.asarray(p["inv_s2"]), max_dist=1.0, ratio=0.9)
    t = tmatch.search_triangulation(*[torch.tensor(p[k]) for k in keys], F,
                                    torch.tensor(p["inv_s2"]), max_dist=1.0, ratio=0.9)
    _assert_search_equal(j, t)


# --------------------------------------------------------------------------- #
# The per-keyframe device functions, on a JAX run's own inputs
# --------------------------------------------------------------------------- #
def test_triangulate_neighbors(jax_run):
    n_checked = n_wide = 0
    for args, kw, (jenc, jX) in jax_run["triangulate"]:
        (f1_desc, f1_uv, f1_level, f1_free, nb_desc, nb_uv, nb_level, nb_free,
         nb_R, nb_t, R1, t1, K, lut) = args
        live = [q for q in range(len(nb_free)) if nb_free[q].any()]
        T = torch.tensor
        enc, X = tmk.triangulate_neighbors(
            T(f1_desc), T(f1_uv), T(f1_level), T(f1_free),
            [T(nb_desc[q]) for q in live], [T(nb_uv[q]) for q in live],
            [T(nb_level[q]) for q in live], T(nb_free[live]), T(nb_R[live]), T(nb_t[live]),
            T(R1), T(t1), T(K), T(lut), **kw)
        enc, X = enc.numpy(), X.numpy()
        jenc, jX = jenc[live].astype(np.int64), jX[live]
        assert (enc == jenc).mean() >= 0.995
        both = (enc >= 0) & (enc == jenc)
        # The midpoint's 2x2 solve cancels as the rays near parallel: its f32
        # rounding is amplified by ~1/sin^2(parallax).  Points seen under
        # more than ~5.7 degrees hold 1e-4; the rest (down to the 1.1-degree
        # gate) 3e-3 relative (measured worst: 1.2e-3).
        c1 = -R1.T @ t1
        c2 = -np.einsum("qji,qj->qi", nb_R[live], nb_t[live])[:, None, :]
        r1, r2 = jX - c1, jX - c2
        cosp = (r1 * r2).sum(-1) / (np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1))
        wide = both & (cosp < 0.995)
        np.testing.assert_allclose(X[wide], jX[wide], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(X[both], jX[both], rtol=3e-3, atol=1e-4)
        n_wide += int(wide.sum())
        # the reference's padded slots match nothing
        dead = [q for q in range(len(nb_free)) if q not in live]
        assert (np.asarray(jax_run["triangulate"][0][2][0])[dead] == -1).all()
        n_checked += int(both.sum())
    assert n_checked > 30 and n_wide > 10, (n_checked, n_wide)


def test_fuse_pairs(jax_run):
    n_checked = 0
    for args, kw, jenc in jax_run["fuse"]:
        (pos, normal, mind, maxd, desc, valid, pose, d_desc, d_uv, d_level, d_valid,
         K, scales) = args
        assert desc.dtype == jnp.bfloat16  # the block ships as bf16 by default
        n_live = int(valid.any(axis=1).sum())
        assert valid[:n_live].any(axis=1).all()
        T = torch.tensor
        enc = tmk.fuse_pairs(
            T(pos), T(normal), T(mind), T(maxd),
            T(np.asarray(desc, np.float32)).to(torch.bfloat16), T(valid), T(pose),
            [T(x) for x in d_desc], [T(x) for x in d_uv], [T(x) for x in d_level],
            [T(x) for x in d_valid], T(K), T(scales), n_live=n_live, **kw).numpy()
        assert enc.shape == jenc.shape
        assert (enc == jenc).mean() >= 0.995
        assert (enc[n_live:] == -1).all() and (jenc[n_live:] == -1).all()
        n_checked += int((enc >= 0).sum())
    assert n_checked > 100


# --------------------------------------------------------------------------- #
# The store copy
# --------------------------------------------------------------------------- #
def _fake_features(g, n):
    desc = g.standard_normal((n, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return (g.uniform(0, 300, (n, 2)).astype(np.float32),) * 2 + (
        g.integers(0, 4, n).astype(np.int32), g.uniform(0, 6, n).astype(np.float32),
        g.uniform(size=n).astype(np.float32), desc, g.uniform(size=n) > 0.1)


def _assert_stores_equal(js, ts):
    a, b = snapshot(js), snapshot(ts)
    for name in TStore.ARRAYS:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert (a["n_kf"], a["n_mp"]) == (b["n_kf"], b["n_mp"])
    for ha, hb in zip(a["kf_host"], b["kf_host"]):
        for x, y in zip(ha, hb):
            np.testing.assert_array_equal(x, y)


def test_map_store_same_calls():
    """Both stores through one scripted sequence that reaches every mutator,
    keyframe/point/observation growth included."""
    g = np.random.default_rng(0)
    n = 40
    js, ts = JStore(2, 8, n, 2), TStore(2, 8, n, 2)
    scales = np.asarray([1.2 ** i for i in range(4)], np.float32)
    pose = np.array([0.99, 0.05, -0.02, 0.01, 0.3, -0.1, 0.5], np.float32)
    for k in range(5):
        f = _fake_features(g, n)
        p = pose + 0.1 * k
        assert js.add_keyframe(p, 10 * k, JFeatures(*map(jnp.asarray, f))) == \
            ts.add_keyframe(p, 10 * k, torch_features(f)) == k
    for m in range(30):
        x, d = g.standard_normal(3) + [0, 0, 5], g.standard_normal(128)
        assert js.add_map_point(x, d, m % 5) == ts.add_map_point(x, d, m % 5)
    ops = []
    for m in range(30):
        for k in g.choice(5, g.integers(1, 5), replace=False):
            ops.append(("add_observation", (m, int(k), int(g.integers(n)))))
    ops += [("erase_observation", (3, 1)), ("erase_observation", (4, 0)),
            ("replace_map_point", (5, 6)), ("replace_map_point", (7, 7)),
            ("replace_map_point", (8, 6)), ("erase_map_point", (9,)),
            ("add_observation", (9, 1, 3)),  # on an erased point: ignored
            ("set_kf_pose", (2, pose * 1.01))]
    ops += [("compute_distinctive_descriptor", (m,)) for m in range(0, 30, 2)]
    ops += [("compute_distinctive_descriptors", (np.arange(1, 30, 2),))]
    ops += [("update_normals_batch", (np.arange(30), scales)),
            ("update_normal_and_depth", (12, scales))]
    for name, args in ops:
        if name == "compute_distinctive_descriptors":  # the reference's one-point loop
            for m in args[0]:
                js.compute_distinctive_descriptor(int(m))
        else:
            getattr(js, name)(*args)
        getattr(ts, name)(*args)
    _assert_stores_equal(js, ts)
    assert ts.max_kfs == 8 and ts.max_pts == 32 and ts.max_obs >= 4
    for k in range(5):
        assert js.covisibility_weights(k) == ts.covisibility_weights(k)
        assert js.covisible_kfs(k, min_weight=1, max_n=3) == ts.covisible_kfs(k, 1, 3)
    ids = np.array([5, 8, -1, 6, 9])
    np.testing.assert_array_equal(js.resolve_replacements(ids), ts.resolve_replacements(ids))
    np.testing.assert_array_equal(js.local_map_points([0, 2]), ts.local_map_points([0, 2]))
    for x, y in zip(js.observation_rows(np.arange(12)), ts.observation_rows(np.arange(12))):
        np.testing.assert_array_equal(x, y)
    # from_arrays: a third store from the JAX one's arrays is the same store
    _assert_stores_equal(js, torch_store(snapshot(js)))
    js.clear(), ts.clear()
    _assert_stores_equal(js, ts)
