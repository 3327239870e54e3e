"""Parity of the port's triangulation, two-view bootstrap and PnP RANSAC
with the JAX package's, on the scenes of tests/test_twoview.py.

The RANSAC draw matrix is taken from ``jax.random.uniform(key, (iters, N))``
(what the reference draws inside) and handed to the port, so both sides
sample the same hypotheses.  Tolerances: triangulation 1e-5 at a wide
baseline (at a narrow one the midpoint's 2x2 solve cancels, and the two
packages' f32 roundings show as 5e-5 relative: bar 1e-4 relative there);
``success``, ``used_homography`` and the chosen candidate equal, R and t
within 1e-4, ``good`` equal on >= 99% of the points.  The PnP pose comes from
an unnormalised 12-dim DLT whose conditioning shows the rounding as ~5e-4 in
R (measured; both sides count the same inliers): bar 2e-3, before the
caller's pose-only polish."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asdslam_tpu.estimators import pnp as jpnp
from asdslam_tpu.estimators import twoview as jtv
from asdslam_tpu.geometry import se3 as jse3
from asdslam_tpu.geometry import triangulation as jtri
from asdslam_torch.estimators import pnp as tpnp
from asdslam_torch.estimators import twoview as ttv
from asdslam_torch.geometry import triangulation as ttri

K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def _T(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _pose(xi):
    R, t = jse3.se3_exp(jnp.asarray(xi, jnp.float32))
    return np.asarray(R), np.asarray(t)


def make_scene(seed, n=300, planar=False, noise=0.5, outlier_frac=0.1, motion=True):
    """tests/test_twoview.py::make_scene, with numpy draws."""
    g = np.random.default_rng(seed)
    if planar:
        X = np.concatenate([g.uniform(-2, 2, (n, 2)), np.full((n, 1), 6.0)], axis=1)
    else:
        X = g.uniform(-2, 2, (n, 3)) + np.array([0.0, 0.0, 6.0])
    X = X.astype(np.float32)
    xi = [0.02, -0.05, 0.01, 0.6, 0.05, 0.1] if motion else [0.02, -0.03, 0.01, 0, 0, 0]
    R2, t2 = _pose(xi)

    def proj(Xc):
        uvh = Xc @ K.T
        return uvh[:, :2] / uvh[:, 2:3]

    uv1 = proj(X) + noise * g.standard_normal((n, 2))
    uv2 = proj(X @ R2.T + t2) + noise * g.standard_normal((n, 2))
    n_out = int(n * outlier_frac)
    uv2[:n_out] = g.uniform(0, 480, (n_out, 2))
    valid = np.ones(n, bool)
    valid[-7:] = False  # some masked columns: their draws are forced to -1
    return uv1.astype(np.float32), uv2.astype(np.float32), valid, R2, t2, X


@pytest.mark.parametrize("baseline,atol,rtol", [(3.0, 1e-5, 0.0), (0.6, 0.0, 1e-4)])
def test_triangulation_functions(baseline, atol, rtol):
    g = np.random.default_rng(0)
    n = 200
    X = (g.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])).astype(np.float32)
    R1, t1 = _pose([0.01, 0.02, -0.01, 0.1, 0.0, 0.05])
    R2, t2 = _pose([0.02, -0.05, 0.01, baseline, 0.05, 0.1])

    def norm_proj(R, t):
        xc = X @ R.T + t
        return (xc[:, :2] / xc[:, 2:] + 1e-3 * g.standard_normal((n, 2))).astype(np.float32)

    x1, x2 = norm_proj(R1, t1), norm_proj(R2, t2)
    P1 = np.concatenate([R1, t1[:, None]], 1)
    P2 = np.concatenate([R2, t2[:, None]], 1)
    bc = lambda a: np.broadcast_to(a, (n,) + a.shape).copy()

    j = jtri.triangulate_dlt(*map(jnp.asarray, (bc(P1), bc(P2), x1, x2)))
    t = ttri.triangulate_dlt(*_T(bc(P1), bc(P2), x1, x2))
    # the eigenvector's sign is free; the dehomogenised point is not.  The
    # two eigh routines differ by ~1e-5 relative on these 4x4 systems.
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=max(atol, 2e-4))

    args = (bc(R1), bc(t1), bc(R2), bc(t2), x1, x2)
    jm = jtri.triangulate_midpoint(*map(jnp.asarray, args))
    tm = ttri.triangulate_midpoint(*_T(*args))
    np.testing.assert_allclose(np.asarray(jm), tm.numpy(), atol=atol, rtol=rtol)
    assert np.median(np.abs(tm.numpy() - X)) < 0.05  # 1e-3 noise at these depths

    Rs = np.stack([bc(R1), bc(R2)], 1)
    ts = np.stack([bc(t1), bc(t2)], 1)
    xns = np.stack([x1, x2], 1)
    valid = g.uniform(size=(n, 2)) > 0.05
    X0 = X + 0.05 * g.standard_normal(X.shape).astype(np.float32)
    jr = jtri.refine_point_gn(*map(jnp.asarray, (Rs, ts, xns, X0, valid)))
    tr = ttri.refine_point_gn(*_T(Rs, ts, xns, X0, valid))
    both = valid.all(1)  # one view alone leaves the depth free
    np.testing.assert_allclose(np.asarray(jr)[both], tr.numpy()[both], atol=1e-4, rtol=rtol)

    je, jz = jtri.reprojection_error2(*map(jnp.asarray, (R2, t2, X, x2)))
    te, tz = ttri.reprojection_error2(*_T(R2, t2, X, x2))
    np.testing.assert_allclose(np.asarray(je), te.numpy(), atol=1e-7)
    np.testing.assert_allclose(np.asarray(jz), tz.numpy(), atol=1e-5)
    c1, c2 = -R1.T @ t1, -R2.T @ t2
    jc = jtri.parallax_cos(*map(jnp.asarray, (c1, c2, X)))
    tc = ttri.parallax_cos(*_T(c1, c2, X))
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), atol=1e-6)


SCENES = {
    "general": dict(seed=3, key=4),
    "planar": dict(seed=5, key=6, planar=True, outlier_frac=0.05),
    "pure_rotation": dict(seed=7, key=8, motion=False, noise=0.0, outlier_frac=0.0),
    "low_noise": dict(seed=9, key=10, noise=0.1, outlier_frac=0.0),
}


@pytest.mark.parametrize("name", SCENES)
def test_initialize_two_view(name):
    kw = dict(SCENES[name])
    key = jax.random.PRNGKey(kw.pop("key"))
    uv1, uv2, valid, R_gt, t_gt, X = make_scene(**kw)
    jres = jtv.initialize_two_view(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                   jnp.asarray(valid), jnp.asarray(K))
    g = np.asarray(jax.random.uniform(key, (200, len(valid))))
    tres = ttv.initialize_two_view(*_T(g, uv1, uv2, valid, K))
    assert bool(jres.success) == bool(tres.success)
    assert bool(jres.used_homography) == bool(tres.used_homography)
    assert bool(tres.success) == (name != "pure_rotation")
    # a homography explains a pure rotation as well as a plane
    assert bool(tres.used_homography) == (name in ("planar", "pure_rotation"))
    # the chosen model's score tightly; the other model is degenerate on a
    # plane (any F through the plane's homography fits), so its best
    # hypothesis is decided by rounding
    chosen = "score_h" if bool(tres.used_homography) else "score_f"
    for field in ("score_h", "score_f"):
        np.testing.assert_allclose(np.asarray(getattr(jres, field)),
                                   float(getattr(tres, field)),
                                   rtol=1e-4 if field == chosen else 2e-2)
    if name == "pure_rotation":
        return  # no candidate is meaningful: both sides refuse, nothing else to hold
    # the same candidate of the 12: R and t within 1e-4
    np.testing.assert_allclose(np.asarray(jres.R), tres.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jres.t), tres.t.numpy(), atol=1e-4)
    same = np.asarray(jres.good) == tres.good.numpy()
    assert same.mean() >= 0.99, same.mean()
    both = np.asarray(jres.good) & tres.good.numpy()
    np.testing.assert_allclose(np.asarray(jres.points)[both], tres.points.numpy()[both],
                               atol=1e-3)
    assert both.sum() > 150


def test_sampling_matches_top_k():
    """Masked columns draw -1.0 everywhere: the samples must break those
    ties as jax.lax.top_k does (towards the lower index)."""
    g = np.random.default_rng(0).uniform(size=(50, 40)).astype(np.float32)
    valid = np.zeros(40, bool)
    valid[[3, 9, 17, 30, 31]] = True  # fewer valid than k: ties among masked
    gj = jnp.where(jnp.asarray(valid)[None, :], jnp.asarray(g), -1.0)
    _, want = jax.lax.top_k(gj, 8)
    got = ttv.sample_rows(torch.tensor(g), torch.tensor(valid), 8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    x = torch.tensor([1.0, 5.0, 5.0, 2.0, 5.0])
    assert int(ttv.first_argmax(x)) == 1 == int(jnp.argmax(jnp.asarray(x.numpy())))


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp(seed):
    g = np.random.default_rng(seed)
    n = 300
    X = (g.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])).astype(np.float32)
    R, t = _pose([0.05, -0.1, 0.03, 0.4, -0.2, 0.3])
    xc = X @ R.T + t
    uv = (xc[:, :2] / xc[:, 2:] * 500.0 + np.array([320.0, 240.0])).astype(np.float32)
    uv += 0.3 * g.standard_normal(uv.shape).astype(np.float32)
    uv[:45] = g.uniform(0, 480, (45, 2))
    valid = g.uniform(size=n) > 0.1
    chi2 = np.full(n, 5.991, np.float32)
    key = jax.random.PRNGKey(100 + seed)
    jres = jpnp.ransac_pnp(key, *map(jnp.asarray, (X, uv, valid, K, chi2)))
    draws = np.asarray(jax.random.uniform(key, (300, n)))
    tres = tpnp.ransac_pnp(*_T(draws, X, uv, valid, K, chi2))
    assert bool(jres.success) and bool(tres.success)
    assert int(jres.n_inliers) == int(tres.n_inliers)
    np.testing.assert_allclose(np.asarray(jres.R), tres.R.numpy(), atol=2e-3)
    np.testing.assert_allclose(np.asarray(jres.t), tres.t.numpy(), atol=2e-2)
    same = np.asarray(jres.inliers) == tres.inliers.numpy()
    assert same.mean() >= 0.99
    assert np.abs(tres.R.numpy() - R).max() < 0.02
