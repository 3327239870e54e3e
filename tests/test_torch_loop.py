"""Parity of the port's loop-closure layer with the JAX package's: Sim(3)
geometry, Horn alignment / refinement / RANSAC, the vocabulary and the
keyframe database, the essential-graph and global BA optimizers, the two-way
guided gate, and one ``LoopCloser.process`` from a shared state on which the
JAX closer accepts a loop.

Random draws are replayed: the port's estimators and the vocabulary take
their draws as arguments, and the tests pass the JAX keys' streams.

Bars (stated per test): float32 closed forms within 1e-5; the iterative
solvers (LM, PCG, Lloyd) within the bar their conditioning allows, each
measured and recorded in ROADMAP Queue 3; indices, masks, words and
candidate lists exact.

Run as a script it prints the JAX package's result on chip_smoke.py's phase-6
sequence (the circle of tests/test_e2e_loop.py at the full KITTI shape,
SlamConfig() defaults, loop closing, trained ASDNet), on the CPU:

    python tests/test_torch_loop.py --reference-loop

and with ``--port-loop`` the port's result on the same frames, on the CPU
(the port's own RANSAC draws, as on the card).
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
import jax.numpy as jnp

from asdslam_tpu.backend import global_ba as jgba
from asdslam_tpu.backend import pose_graph as jpg
from asdslam_tpu.estimators import sim3_horn as jsh
from asdslam_tpu.geometry import se3 as jse3
from asdslam_tpu.geometry import sim3 as jsim3
from asdslam_tpu.loop import vocab as jvocab
from asdslam_tpu.loop.keyframe_db import KeyFrameDatabase as JDB
from asdslam_torch.backend import ba as tba
from asdslam_torch.backend import global_ba as tgba
from asdslam_torch.backend import pose_graph as tpg
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.estimators import sim3_horn as tsh
from asdslam_torch.geometry import se3 as tse3
from asdslam_torch.geometry import sim3 as tsim3
from asdslam_torch.loop import vocab as tvocab
from asdslam_torch.loop.keyframe_db import KeyFrameDatabase as TDB
from asdslam_torch.loop.loop_closing import LoopCloser as TLoopCloser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KM = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def T(x):
    return torch.tensor(np.asarray(x))


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes, and the test processes that run side by side would only
    fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Sim(3) and the Horn estimators
# --------------------------------------------------------------------------- #
def test_sim3_ops():
    """exp, log, retract, compose, inverse on random tangents: 1e-5."""
    g = np.random.default_rng(0)
    xi = (g.normal(0, 0.4, (64, 7))).astype(np.float32)
    xi[:8, :3] = 0.0           # theta below the small-angle branch
    xi[8:16, 6] = 1e-7         # sigma below the small-scale branch
    xj = g.normal(0, 0.3, (64, 7)).astype(np.float32)
    sj, Rj, tj = jsim3.sim3_exp(jnp.asarray(xi))
    st, Rt, tt = tsim3.sim3_exp(T(xi))
    for a, b in ((sj, st), (Rj, Rt), (tj, tt)):
        close(b, a, 1e-5, 1e-5)
    close(tsim3.sim3_log(st, Rt, tt), jsim3.sim3_log(sj, Rj, tj), 1e-5, 1e-4)
    pj = jsim3.sim3_pack(sj, Rj, tj)
    pt = tsim3.sim3_pack(st, Rt, tt)
    close(tsim3.retract(pt, T(xj)), jsim3.retract(pj, jnp.asarray(xj)), 1e-5, 1e-5)
    cj = jsim3.compose(sj, Rj, tj, *jsim3.inverse(sj[::-1], Rj[::-1], tj[::-1]))
    ct = tsim3.compose(st, Rt, tt, *tsim3.inverse(st.flip(0), Rt.flip(0), tt.flip(0)))
    for a, b in zip(cj, ct):
        close(b, a, 1e-5, 1e-5)


def _pair_problem(seed=1, n=80, n_bad=20):
    """TestHorn.test_ransac_with_outliers' problem, from numpy."""
    g = np.random.default_rng(seed)
    P1 = (g.uniform(-2, 2, (n, 3)) + [0.0, 0.0, 6.0]).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.array([0.05, 0.3, -0.1])))
    P2 = (0.8 * P1 @ R.T + np.array([1.0, 0.2, -0.5])).astype(np.float32)
    P2[:n_bad] += (g.normal(0, 3.0, (n_bad, 3))).astype(np.float32)

    def proj(P):
        return np.stack([500 * P[:, 0] / P[:, 2] + 320, 500 * P[:, 1] / P[:, 2] + 240],
                        1).astype(np.float32)
    return P1, P2, proj(P1), proj(P2)


def test_horn_sim3():
    """Batched and weighted closed form: 1e-5 (s, t relative)."""
    g = np.random.default_rng(2)
    P1 = g.normal(0, 1, (5, 30, 3)).astype(np.float32)
    P2 = (1.3 * P1 + g.normal(0, 0.05, P1.shape)).astype(np.float32)
    w = g.uniform(0, 1, (5, 30)).astype(np.float32)
    for args in ((P1, P2), (P1, P2, w)):
        j = jsh.horn_sim3(*[jnp.asarray(a) for a in args])
        t = tsh.horn_sim3(*[T(a) for a in args])
        for a, b in zip(j, t):
            close(b, a, 1e-5, 1e-5)


def test_ransac_sim3_replayed_draws():
    """The JAX key's draws replayed: the same best hypothesis (same inliers)
    and its refit within 1e-5."""
    P1, P2, uv1, uv2 = _pair_problem()
    N = len(P1)
    th = np.full(N, 9.21, np.float32)
    key = jax.random.PRNGKey(3)
    j = jsh.ransac_sim3(key, *map(jnp.asarray, (P1, P2, uv1, uv2)), jnp.ones(N, bool),
                        jnp.asarray(KM), jnp.asarray(th), jnp.asarray(th),
                        iters=200, min_inliers=20)
    g = T(jax.random.uniform(key, (200, N)))
    t = tsh.ransac_sim3(g, *map(T, (P1, P2, uv1, uv2)), torch.ones(N, dtype=torch.bool),
                        T(KM), T(th), T(th), min_inliers=20)
    assert bool(t.success) == bool(j.success) is True
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)
    for a, b in ((j.s, t.s), (j.R, t.R), (j.t, t.t)):
        close(b, a, 1e-5, 1e-5)


def test_refine_sim3():
    """Ten LM steps from the JAX RANSAC's estimate and inliers, with noisy
    observations: the same inliers, s/R/t within 1e-5."""
    P1, P2, uv1, uv2 = _pair_problem()
    N = len(P1)
    g = np.random.default_rng(9)
    uv1 = (uv1 + g.normal(0, 0.7, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + g.normal(0, 0.7, uv2.shape)).astype(np.float32)
    th = np.full(N, 9.21, np.float32)
    r = jsh.ransac_sim3(jax.random.PRNGKey(3), *map(jnp.asarray, (P1, P2, uv1, uv2)),
                        jnp.ones(N, bool), jnp.asarray(KM), jnp.asarray(th), jnp.asarray(th),
                        iters=200, min_inliers=20)
    s0, R0, t0, valid = (np.asarray(x) for x in (r.s, r.R, r.t, r.inliers))
    inv = np.ones(N, np.float32)
    j = jsh.refine_sim3(jnp.float32(s0), jnp.asarray(R0), jnp.asarray(t0),
                        *map(jnp.asarray, (P1, P2, uv1, uv2, valid)), jnp.asarray(KM),
                        jnp.asarray(inv), jnp.asarray(inv))
    t = tsh.refine_sim3(torch.tensor(s0), T(R0), T(t0), *map(T, (P1, P2, uv1, uv2, valid)),
                        T(KM), T(inv), T(inv))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    assert t[3].sum() >= 55
    for a, b in zip(j[:3], t[:3]):
        close(b, a, 1e-5, 1e-5)


def test_optimize_sim3_align():
    """TestSim3Align's problem: the same inliers, s/R/t within 1e-5."""
    g = np.random.default_rng(3)
    N = 200
    X = g.uniform(-5, 5, (N, 3)).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.array([0.1, -0.2, 0.3])))
    Y = (1.4 * X @ R.T + [2.0, -1.0, 0.5] + 0.01 * g.normal(size=(N, 3))).astype(np.float32)
    Y[:40] += (5.0 * g.normal(size=(40, 3))).astype(np.float32)
    j = jsh.optimize_sim3_align(jnp.asarray(X), jnp.asarray(Y), jnp.ones(N, bool))
    t = tsh.optimize_sim3_align(T(X), T(Y), torch.ones(N, dtype=torch.bool))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    for a, b in zip(j[:3], t[:3]):
        close(b, a, 1e-5, 1e-5)


# --------------------------------------------------------------------------- #
# Vocabulary and keyframe database
# --------------------------------------------------------------------------- #
def _clustered_descs(n=2000, k=20, seed=4):
    g = np.random.default_rng(seed)
    centers = g.normal(size=(k, 128)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return (centers[g.integers(0, k, n)] + 0.05 * g.normal(size=(n, 128))).astype(np.float32)


def jax_rand_idx(key, n, branching, depth):
    """The fallback picks ``vocab.train_vocab`` draws from ``key``."""
    out = []
    for level in range(1, depth + 1):
        key, k1 = jax.random.split(key)
        out.append(T(jax.random.randint(k1, (branching ** level,), 0, n)).long())
    return out


def to_torch_vocab(v):
    return tvocab.Vocabulary(levels=[T(l) for l in v.levels], idf=T(v.idf),
                             branching=v.branching, depth=v.depth)


@pytest.mark.parametrize("branching,depth", [(5, 2), (4, 3)])
def test_train_vocab_replayed_draws(branching, depth):
    """The same word for every training descriptor; centroids within 1e-6
    (the port's Lloyd sums are exact, the reference's f32 sums in index
    order: they differ by rounding only)."""
    d = _clustered_descs()
    key = jax.random.PRNGKey(7)
    jv = jvocab.train_vocab(key, jnp.asarray(d), branching=branching, depth=depth)
    tv = tvocab.train_vocab(T(d), jax_rand_idx(key, len(d), branching, depth),
                            branching=branching, depth=depth)
    for a, b in zip(jv.levels, tv.levels):
        close(b, a, 1e-6)
    close(tv.idf, jv.idf, 1e-6)
    np.testing.assert_array_equal(tvocab.transform(tv, T(d)).numpy(),
                                  np.asarray(jvocab.transform(jv, jnp.asarray(d))))


def test_transform_bow_and_score():
    """Words exact (invalid rows -1), bow vectors and L1 scores within 1e-7,
    on the JAX package's vocabulary file."""
    jv = jvocab.load_vocab(os.path.join(ROOT, "voc_patch_r04.npz"))
    tv = to_torch_vocab(jv)
    g = np.random.default_rng(5)
    d = g.normal(size=(3, 600, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = g.uniform(size=(3, 600)) > 0.2
    bows = []
    for i in range(3):
        wj = np.asarray(jvocab.transform(jv, jnp.asarray(d[i]), jnp.asarray(valid[i])))
        wt = tvocab.transform(tv, T(d[i]), T(valid[i]))
        np.testing.assert_array_equal(wt.numpy(), wj)
        bj, bt = jvocab.bow_vector(jv, wj), tvocab.bow_vector(tv, wt)
        close(bt, bj, 1e-7)
        bows.append((bj, bt))
    for (aj, at), (bj, bt) in ((bows[0], bows[1]), (bows[0], bows[0]), (bows[1], bows[2])):
        assert abs(tvocab.score_l1(at, bt) - jvocab.score_l1(aj, bj)) < 1e-7


def test_vocab_file_loads_identically(tmp_path):
    """voc_patch_r04.npz loaded by both packages: identical arrays and
    words; a save by the port reloads in the JAX package unchanged."""
    path = os.path.join(ROOT, "voc_patch_r04.npz")
    jv, tv = jvocab.load_vocab(path), tvocab.load_vocab(path, device="cpu")
    assert (tv.branching, tv.depth, tv.n_words) == (jv.branching, jv.depth, jv.n_words)
    for a, b in zip(jv.levels, tv.levels):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    d = np.random.default_rng(6).normal(size=(500, 128)).astype(np.float32)
    np.testing.assert_array_equal(tvocab.transform(tv, T(d)).numpy(),
                                  np.asarray(jvocab.transform(jv, jnp.asarray(d))))
    tvocab.save_vocab(tv, str(tmp_path / "v.npz"))
    again = jvocab.load_vocab(str(tmp_path / "v.npz"))
    for a, b in zip(jv.levels, again.levels):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_keyframe_database_candidates():
    """Loop and relocalization candidates, with exclusions, a min score and
    covisibility groups: equal lists."""
    cfg = TConfig()
    g = np.random.default_rng(8)
    W, K = 300, 40
    bows = g.uniform(size=(K, W)).astype(np.float32) * (g.uniform(size=(K, W)) < 0.1)
    bows[20:30] = bows[:10] + 0.3 * bows[20:30]          # revisits of 0-9
    bows /= bows.sum(1, keepdims=True)
    jdb, tdb = JDB(cfg, W, 16), TDB(cfg, W, 16)        # both grow past 16
    for k in range(K - 1):
        jdb.add(k, bows[k])
        tdb.add(k, bows[k])
    jdb.erase(5)
    tdb.erase(5)

    def covis(k):
        return [int(x) for x in ((k + np.arange(1, 4)) % K)]

    q = bows[25]
    for db_args in [((24, q, {23, 24, 26}, 0.05, covis), {}),
                    ((24, q, set(range(15, 25)), 0.0, covis), {}),
                    ((24, q, set(), 0.2, covis), {"restrict_mask": np.arange(K) < 12})]:
        a, kw = db_args
        assert tdb.detect_loop_candidates(*a, **kw) == jdb.detect_loop_candidates(*a, **kw)
    assert tdb.detect_reloc_candidates(q, covis) == jdb.detect_reloc_candidates(q, covis)
    assert tdb.detect_reloc_candidates(q, covis)  # non-empty


# --------------------------------------------------------------------------- #
# Optimizers
# --------------------------------------------------------------------------- #
def _pose_graph_problem():
    """TestPoseGraph's problem: a drifted 10-node chain and a loop edge."""
    Kn = 10
    rng = np.random.default_rng(0)
    gt = [jsim3.sim3_identity()]
    for _ in range(1, Kn):
        gt.append(jsim3.retract(gt[-1], jnp.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])))
    gt = jnp.stack(gt)
    drift = [np.asarray(gt[0])]
    for _ in range(1, Kn):
        step = np.array([0., 0., 0.03, 1.0, 0.02, 0.0, 0.005])
        drift.append(np.asarray(jsim3.retract(jnp.asarray(drift[-1]),
                                              jnp.asarray(step + rng.normal(0, 0.005, 7)))))
    i_, j_, meas, wts = [], [], [], []
    for a, b, w in [(i, i + 1, 1.0) for i in range(Kn - 1)] + [(0, 9, 5.0)]:
        Sa, Sb = jsim3.sim3_unpack(gt[a]), jsim3.sim3_unpack(gt[b])
        meas.append(np.asarray(jsim3.sim3_pack(*jsim3.compose(*Sb, *jsim3.inverse(*Sa)))))
        i_.append(a)
        j_.append(b)
        wts.append(w)
    fixed = np.zeros(Kn, bool)
    fixed[0] = True
    return (np.stack(drift).astype(np.float32), np.array(i_), np.array(j_),
            np.stack(meas).astype(np.float32), np.array(wts, np.float32), fixed, np.asarray(gt))


def test_optimize_pose_graph():
    """15 LM steps of 150 PCG iterations: poses within 1e-5 (the per-node
    sums run in another order), and the loop pulled back as the reference's
    test asks (mean centre error under a fifth of the drift)."""
    poses0, i_, j_, meas, w, fixed, gt = _pose_graph_problem()
    je = jpg.PoseGraphEdges(i=jnp.asarray(i_, jnp.int32), j=jnp.asarray(j_, jnp.int32),
                            meas=jnp.asarray(meas), weight=jnp.asarray(w),
                            valid=jnp.ones(len(w), bool))
    te = tpg.PoseGraphEdges(i=T(i_), j=T(j_), meas=T(meas), weight=T(w),
                            valid=torch.ones(len(w), dtype=torch.bool))
    jo = np.asarray(jpg.optimize_pose_graph(jnp.asarray(poses0), je, jnp.asarray(fixed),
                                            iters=15))
    to = tpg.optimize_pose_graph(T(poses0), te, T(fixed), iters=15).numpy()
    close(to, jo, 1e-5)

    def centres(p):
        s, R, t = tsim3.sim3_unpack(T(p))
        return (-(R.transpose(1, 2) @ t[:, :, None])[:, :, 0] / s[:, None]).numpy()
    err0 = np.linalg.norm(centres(poses0) - centres(gt), axis=1).mean()
    err1 = np.linalg.norm(centres(to) - centres(gt), axis=1).mean()
    assert err1 < 0.2 * err0, (err0, err1)


def test_edge_jacobians_match_jacfwd():
    """The edge residuals and Jacobians (seven JVPs per endpoint) against
    jax.jacfwd vmapped over the edges: residuals 1e-6, Jacobians 1e-5."""
    poses0, i_, j_, meas, w, fixed, gt = _pose_graph_problem()
    Si, Sj = poses0[i_], poses0[j_]
    z = np.zeros((len(i_), 7), np.float32)

    def je_of(xi_i, xi_j, a, b, m):
        return jpg.edge_residual(jsim3.retract(a, xi_i), jsim3.retract(b, xi_j), m)
    e, Ji, Jj = tpg.edge_jacobians(T(Si), T(Sj), T(meas))
    close(e, jax.vmap(je_of)(*map(jnp.asarray, (z, z, Si, Sj, meas))), 1e-6)
    for arg, tj in ((0, Ji), (1, Jj)):
        jj = jax.vmap(jax.jacfwd(je_of, argnums=arg))(*map(jnp.asarray, (z, z, Si, Sj, meas)))
        close(tj, jj, 1e-5, 1e-5)


@pytest.fixture(scope="module")
def gba_helper():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_ba import K as JK, TestBundleAdjust
    return TestBundleAdjust(), JK


@pytest.mark.parametrize("case", ["small", "larger"])
def test_global_bundle_adjust(gba_helper, case):
    """tests/test_global_ba.py's two problems (the small one against the
    dense Schur BA there, the larger from an 8% perturbation): poses and
    points within 2e-5 of the JAX optimizer's on the small problem (measured
    8.1e-6), 3e-4 on the larger (measured 1.43e-4): 15 LM steps of 30-40 PCG
    iterations in f32 whose per-camera and per-point sums run in another
    order (ROADMAP Queue 3); chi2 within 1e-3 relative; with and without
    the gather tables given."""
    helper, JK = gba_helper
    kw = dict(small=dict(), larger=dict(n_cams=12, n_pts=400, perturb=0.08))[case]
    bar = dict(small=2e-5, larger=3e-4)[case]
    prob, poses_gt, X_gt, n_opt = helper.make_problem(jax.random.PRNGKey(
        11 if case == "small" else 12), **kw)
    cg = 30 if case == "small" else 40
    jp, jx, jc = jgba.global_bundle_adjust(prob.poses7, prob.points, prob.pt_valid, prob.obs,
                                           JK, n_opt=n_opt, iters=15, cg_iters=cg)
    obs = tba.Obs(*[T(a) for a in prob.obs])
    args = (T(prob.poses7), T(prob.points), T(prob.pt_valid), obs, T(JK))
    tp, tx, tc = tgba.global_bundle_adjust(*args, n_opt=n_opt, iters=15, cg_iters=cg)
    close(tp, jp, bar)
    close(tx, jx, bar)
    fin = np.isfinite(np.asarray(jc))
    np.testing.assert_array_equal(np.isfinite(tc.numpy()), fin)
    close(tc.numpy()[fin], np.asarray(jc)[fin], 1e-3, 1e-3)
    tables = (T(tba.build_pt_obs(np.asarray(prob.obs.pt_idx), np.asarray(prob.obs.valid),
                                 prob.points.shape[0], 16)),
              T(tba.build_pt_obs(np.asarray(prob.obs.cam_idx), np.asarray(prob.obs.valid),
                                 n_opt, 512)))
    tp2, tx2, _ = tgba.global_bundle_adjust(*args, n_opt=n_opt, iters=15, cg_iters=cg,
                                            pt_obs=tables[0], cam_obs=tables[1])
    close(tp2, jp, bar)
    close(tx2, jx, bar)


# --------------------------------------------------------------------------- #
# The loop closer
# --------------------------------------------------------------------------- #
def test_two_way_gate_aliasing():
    """TestBidirectionalSim3Gate's aliasing case on both packages: the same
    forward and backward guided counts, and the false loop fails the gate."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_loop_components import TestBidirectionalSim3Gate
    from asdslam_torch.frontend.extractor import FrameFeatures as TFeatures
    from asdslam_torch.mapping.map_store import MapStore as TStore

    ref = TestBidirectionalSim3Gate()
    counts = {}
    real_count = None
    for side in ("jax", "torch"):
        cfg, Km, store, lc = ref._make_store()
        if side == "torch":
            store = TStore(max_kfs=8, max_pts=1024, n_feat=128, max_obs=8)
            lc = TLoopCloser(TConfig(n_features=128, image_width=640, image_height=480,
                                     fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                     local_ba_max_points=512),
                             T(KM), store, run_global_ba=False, device="cpu")

            def Feat(uv, desc):
                f = TestBidirectionalSim3Gate.Feat(uv, desc)
                return TFeatures(*[T(getattr(f, k)) for k in TFeatures._fields])
        else:
            Feat = ref.Feat
        real_count = lc._count_guided_matches
        out = []
        lc._count_guided_matches = lambda *a, _f=real_count, _o=out: _o.append(int(_f(*a))) or _o[-1]
        holder = ref._make_store
        ref._make_store = lambda _s=(cfg, Km, store, lc): _s
        ref.Feat = Feat
        try:
            ref.test_one_way_aliasing_is_rejected()
        finally:
            ref._make_store = holder
            ref.Feat = TestBidirectionalSim3Gate.Feat
        counts[side] = out
    assert counts["torch"] == counts["jax"] and len(counts["jax"]) == 2, counts


def _lc_state(lc):
    return dict(kf_bow={k: v.copy() for k, v in lc.kf_bow.items()},
                pending=list(lc.pending), prev_groups=[(set(g), c) for g, c in lc.prev_groups],
                last_loop_kf=lc.last_loop_kf, n_loops_closed=lc.n_loops_closed,
                counters=dict(lc.counters), accepted_log=list(lc.accepted_log),
                db=None if lc.db is None else (lc.db.bow.copy(), lc.db.occ.copy(),
                                               lc.db.present.copy()))


@pytest.fixture(scope="module")
def jax_loop_run():
    """The JAX System over tests/test_e2e_loop.py's circle until its loop
    closer accepts a loop: the store and the closer's state before that
    ``process`` call, the Sim3 it corrected with, the poses after."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_mapping import snapshot
    from test_e2e_loop import loop_config
    from asdslam_tpu.io import synthetic as jsyn
    from asdslam_tpu.models import patch_descriptor as jpatch
    from asdslam_tpu.system import System as JSystem

    cfg = loop_config()
    K = jnp.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, _ = jsyn.render_sequence(
        K, n_frames=155, height=cfg.image_height, width=cfg.image_width, step=0.22,
        turn=2 * np.pi / 110, scene=jsyn.Scene(floor_y=2.0, ceil_y=-3.0, left_x=-8.0,
                                                right_x=8.0, back_z=-8.0, front_z=16.0))
    system = JSystem(cfg.replace(pipelined_tracking=False, async_mapping=False),
                     descriptor_fn=jpatch.apply, do_loop_closing=True)
    lc = system.loop_closer
    rec = {}
    real_process, real_correct = lc.process, lc._correct_loop

    def process(kf):
        if rec.get("accepted"):
            return real_process(kf)
        before = dict(kf=kf, store=snapshot(system.store), lc=_lc_state(lc),
                      loop_edges=list(system.store.loop_edges))
        n = lc.n_loops_closed
        real_process(kf)
        if lc.n_loops_closed > n:
            rec.update(before=before, accepted=True, after=snapshot(system.store),
                       lc_after=_lc_state(lc))

    def correct(kf, cand, S_ck, loop_mps):
        rec["S_ck"] = (float(S_ck[0]), np.array(S_ck[1]), np.array(S_ck[2]))
        return real_correct(kf, cand, S_ck, loop_mps)

    lc.process, lc._correct_loop = process, correct
    for i in range(155):
        system.track_monocular(frames[i], i)
        if rec.get("accepted"):
            break
    assert rec.get("accepted"), "the JAX closer accepted no loop"
    rec["vocab"] = lc.vocab
    rec["cfg"] = cfg
    return rec


def test_loop_closer_process_from_shared_state(jax_loop_run):
    """One LoopCloser.process on the state the JAX closer accepted a loop
    from: the same verdict, candidate and funnel counters; the Sim3's
    rotation and translation within 3e-5 and its scale within 3e-4
    (measured 3.6e-6 / 3.0e-6 / 9.8e-5: ten LM steps in f32, and the scale
    is the weakest direction of the two-way reprojection); every keyframe
    pose after the essential graph and global BA within 5e-4 (measured
    1.1e-4; ROADMAP Queue 3); the same loop edge."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_mapping import torch_store

    rec = jax_loop_run
    before, st = rec["before"], rec["before"]["lc"]
    store = torch_store(before["store"])
    store.loop_edges = list(before["loop_edges"])
    cfg = TConfig(**{f: getattr(rec["cfg"], f) for f in TConfig.__dataclass_fields__})
    lc = TLoopCloser(cfg, T(np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]],
                                      np.float32)), store, vocabulary=to_torch_vocab(rec["vocab"]),
                     device="cpu")
    lc.db = TDB(cfg, lc.vocab.n_words, store.max_kfs)
    lc.db.bow, lc.db.occ, lc.db.present = (a.copy() for a in st["db"])
    lc.kf_bow = {k: v.copy() for k, v in st["kf_bow"].items()}
    lc.prev_groups = [(set(g), c) for g, c in st["prev_groups"]]
    lc.last_loop_kf, lc.n_loops_closed = st["last_loop_kf"], st["n_loops_closed"]
    lc.counters, lc.accepted_log = dict(st["counters"]), list(st["accepted_log"])
    lc._sim3_draws = lambda kf, iters, n: T(jax.random.uniform(jax.random.PRNGKey(kf),
                                                               (iters, n)))
    seen = {}
    real_correct = lc._correct_loop

    def correct(kf, cand, S_ck, loop_mps):
        seen["S_ck"] = S_ck
        return real_correct(kf, cand, S_ck, loop_mps)

    lc._correct_loop = correct
    lc.process(before["kf"])
    after = rec["lc_after"]
    assert lc.accepted_log == after["accepted_log"]
    assert lc.counters == after["counters"]
    assert lc.n_loops_closed == after["n_loops_closed"]
    s_j, R_j, t_j = rec["S_ck"]
    s_t, R_t, t_t = seen["S_ck"]
    close(s_t, s_j, 3e-4)
    close(R_t, R_j, 3e-5)
    close(t_t, t_j, 3e-5)
    ja = rec["after"]
    n = store.n_kf
    live = ja["kf_valid"][:n]
    close(store.kf_pose[:n][live], ja["kf_pose"][:n][live], 5e-4)
    np.testing.assert_array_equal(store.kf_valid[:n], live)
    assert store.loop_edges == list(rec["before"]["loop_edges"]) + [
        tuple(after["accepted_log"][-1][:2])]


def test_loop_closer_refuses_mesh_global_ba():
    """cfg.n_devices > 1 (the mesh global BA) waits for ROADMAP item 13."""
    from asdslam_torch.mapping.map_store import MapStore as TStore
    with pytest.raises(NotImplementedError, match="parallel"):
        TLoopCloser(TConfig(n_devices=2), T(KM), TStore(4, 16, 8), device="cpu")


# --------------------------------------------------------------------------- #
# The yardstick of chip_smoke.py's phase 6
# --------------------------------------------------------------------------- #
def reference_loop(n_frames=155, step=0.22, per_turn=110):
    """The JAX System at the full KITTI shape (SlamConfig() defaults:
    pipelined, asynchronous; loop closing; trained ASDNet) on
    tests/test_e2e_loop.py's circle, on the CPU."""
    import pickle
    import time
    from asdslam_tpu.config import SlamConfig as JConfig
    from asdslam_tpu.io import synthetic as jsyn
    from asdslam_tpu.system import System as JSystem
    from asdslam_tpu.utils import evaluate as jeval

    cfg = JConfig()
    K = jnp.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, poses = jsyn.render_sequence(
        K, n_frames, cfg.image_height, cfg.image_width, step=step,
        turn=2 * np.pi / per_turn, scene=jsyn.Scene(floor_y=2.0, ceil_y=-3.0, left_x=-8.0,
                                                    right_x=8.0, back_z=-8.0, front_z=16.0))
    frames_u8 = np.clip(np.asarray(frames) * 255.0, 0, 255).astype(np.uint8)
    with open(os.path.join(ROOT, "asdnet_weights.pkl"), "rb") as f:
        system = JSystem(cfg, asdnet_params=pickle.load(f), do_loop_closing=True)
    t0 = time.time()
    for i in range(n_frames):
        system.track_monocular(frames_u8[i], i)
    system.finish()
    lc = system.loop_closer
    est = jeval.camera_centers(system.keyframe_trajectory())
    gt = jeval.camera_centers([(i, np.asarray(poses[i])) for i in range(n_frames)])
    e, g = jeval.associate_by_id(est, gt)
    path = float(np.linalg.norm(np.diff(np.stack([gt[i] for i in range(n_frames)]), axis=0),
                                axis=1).sum())
    print(f"JAX System, CPU, {cfg.image_width}x{cfg.image_height}, {cfg.n_features} features, "
          f"{n_frames} frames, step {step} m, a turn in {per_turn} frames: {system.stats()}, "
          f"frames tracked {len(system.frame_trajectory())}, loops {lc.accepted_log}, funnel "
          f"{lc.counters}, keyframe sim3 ATE {jeval.ate_rmse(e, g, align='sim3'):.6f} m over a "
          f"{path:.4f} m path, {time.time() - t0:.0f} s")


def port_loop(n_frames=155, step=0.22, per_turn=110):
    """The port's System on the CPU on reference_loop's frames and
    configuration, with its own RANSAC draws as on the card: separates the
    card's numerics from the port's own arithmetic in the loop frame."""
    import time
    from asdslam_torch.io import synthetic as tsyn
    from asdslam_torch.models.asdnet import load_weights
    from asdslam_torch.system import System as TSystem
    from asdslam_torch.utils import evaluate as teval

    cfg = TConfig()
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, poses = tsyn.render_sequence(
        K, n_frames, cfg.image_height, cfg.image_width, step=step,
        turn=2 * np.pi / per_turn, scene=tsyn.Scene(floor_y=2.0, ceil_y=-3.0, left_x=-8.0,
                                                    right_x=8.0, back_z=-8.0, front_z=16.0),
        device="cpu")
    frames_u8 = (frames * 255.0).clamp(0, 255).to(torch.uint8)
    system = TSystem(cfg, asdnet_params=load_weights(os.path.join(ROOT, "asdnet_weights.pkl")),
                     do_loop_closing=True, device="cpu")
    t0 = time.time()
    for i in range(n_frames):
        system.track_monocular(frames_u8[i], i)
    system.finish()
    lc = system.loop_closer
    est = teval.camera_centers(system.keyframe_trajectory())
    gt = teval.camera_centers([(i, poses[i].numpy()) for i in range(n_frames)])
    e, g = teval.associate_by_id(est, gt)
    print(f"port System, CPU, {cfg.image_width}x{cfg.image_height}, {cfg.n_features} features, "
          f"{n_frames} frames, step {step} m, a turn in {per_turn} frames: {system.stats()}, "
          f"frames tracked {len(system.frame_trajectory())}, loops {lc.accepted_log}, funnel "
          f"{lc.counters}, keyframe sim3 ATE {teval.ate_rmse(e, g, align='sim3'):.6f} m, "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    modes = {"--reference-loop": reference_loop, "--port-loop": port_loop}
    if sys.argv[1:] not in ([m] for m in modes):
        sys.exit(__doc__)
    modes[sys.argv[1]]()
