"""Parity of the port's full bundle adjustment (backend/ba.py) with the JAX
package's, on the problem of tests/test_ba.py::TestBundleAdjust built with
numpy.  ``build_pt_obs`` exact; poses and points within 1e-4; finite chi2
within 1e-3 relative (plus 1e-4 absolute for the near-zero ones); the same
infinite entries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asdslam_tpu.backend import ba as jba
from asdslam_tpu.geometry import se3 as jse3
from asdslam_torch.backend import ba as tba

K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def _retract(pose, xi):
    return np.asarray(jse3.pose_retract(jnp.asarray(pose), jnp.asarray(xi, jnp.float32)))


def _project(pose7, X):
    R, t = (np.asarray(a) for a in jse3.pose_unpack(jnp.asarray(pose7)))
    xc = X @ R.T + t
    return (xc[:, :2] / xc[:, 2:] * 500.0 + np.array([320.0, 240.0])).astype(np.float32)


def make_problem(seed, n_cams=6, n_pts=150, noise=0.3, perturb=0.05, k_max=None,
                 n_invalid=0):
    g = np.random.default_rng(seed)
    X_gt = (g.uniform(-3, 3, (n_pts, 3)) + np.array([0, 0, 8.0])).astype(np.float32)
    ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    poses_gt = np.stack([_retract(ident, [0, 0, 0, 0.4 * c - 1.0, 0, 0.1 * c])
                         for c in range(n_cams)])
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    uv = np.concatenate([_project(poses_gt[c], X_gt) for c in range(n_cams)])
    uv = (uv + noise * g.standard_normal(uv.shape)).astype(np.float32)
    O = uv.shape[0]
    valid = np.ones(O, bool)
    valid[g.choice(O, n_invalid, replace=False)] = False
    inv_s2 = (1.0 / 1.44 ** g.integers(0, 3, O)).astype(np.float32)

    poses0 = poses_gt.copy()
    for c in range(2, n_cams):  # cams 0, 1 stay at the truth: the gauge
        poses0[c] = _retract(poses_gt[c], perturb * g.standard_normal(6))
    X0 = (X_gt + perturb * g.standard_normal(X_gt.shape)).astype(np.float32)
    order = list(range(2, n_cams)) + [0, 1]  # optimized cameras first
    cam_idx = np.argsort(order)[cam_idx]
    poses0, poses_gt = poses0[order], poses_gt[order]
    pt_valid = np.ones(n_pts, bool)
    pt_valid[:3] = n_invalid == 0
    pt_obs = jba.build_pt_obs(pt_idx, valid, n_pts, k_max or n_cams + 2)
    arrays = dict(poses=poses0, points=X0, pt_valid=pt_valid, cam_idx=cam_idx,
                  pt_idx=pt_idx, uv=uv, inv_s2=inv_s2, valid=valid, pt_obs=pt_obs)
    return arrays, poses_gt, X_gt, n_cams - 2


def _jax_problem(a):
    obs = jba.Obs(cam_idx=jnp.asarray(a["cam_idx"], jnp.int32),
                  pt_idx=jnp.asarray(a["pt_idx"], jnp.int32), uv=jnp.asarray(a["uv"]),
                  inv_sigma2=jnp.asarray(a["inv_s2"]), valid=jnp.asarray(a["valid"]))
    return jba.BAProblem(poses7=jnp.asarray(a["poses"]), points=jnp.asarray(a["points"]),
                         pt_valid=jnp.asarray(a["pt_valid"]), obs=obs,
                         pt_obs=jnp.asarray(a["pt_obs"]))


def _torch_problem(a):
    T = torch.tensor
    obs = tba.Obs(cam_idx=T(a["cam_idx"]), pt_idx=T(a["pt_idx"]), uv=T(a["uv"]),
                  inv_sigma2=T(a["inv_s2"]), valid=T(a["valid"]))
    return tba.BAProblem(poses7=T(a["poses"]), points=T(a["points"]),
                         pt_valid=T(a["pt_valid"]), obs=obs, pt_obs=T(a["pt_obs"]))


def test_build_pt_obs_exact():
    g = np.random.default_rng(0)
    pt_idx = g.integers(-2, 60, 900)
    valid = g.uniform(size=900) > 0.2
    for k_max in (4, 8, 32):
        np.testing.assert_array_equal(jba.build_pt_obs(pt_idx, valid, 50, k_max),
                                      tba.build_pt_obs(pt_idx, valid, 50, k_max))
    t = tba.build_pt_obs(pt_idx, valid, 50, 32)
    for p in range(50):
        want = np.nonzero(valid & (pt_idx == p))[0]
        np.testing.assert_array_equal(t[p][t[p] >= 0], want[:32])


@pytest.mark.parametrize("case", ["seed3", "seed4_low_noise", "invalid_obs_huber_off",
                                  "truncated_lists"])
def test_bundle_adjust(case):
    kw = {"seed3": dict(seed=3), "seed4_low_noise": dict(seed=4, noise=0.1),
          "invalid_obs_huber_off": dict(seed=5, n_invalid=60),
          "truncated_lists": dict(seed=6, k_max=4)}[case]
    a, poses_gt, X_gt, n_opt = make_problem(**kw)
    huber = case != "invalid_obs_huber_off"
    jp, jx, jc = jba.bundle_adjust(_jax_problem(a), jnp.asarray(K), n_opt=n_opt, iters=15,
                                   huber=huber)
    tp, tx, tc = tba.bundle_adjust(_torch_problem(a), torch.tensor(K), n_opt=n_opt, iters=15,
                                   huber=huber)
    jp, jx, jc = np.asarray(jp), np.asarray(jx), np.asarray(jc)
    tp, tx, tc = tp.numpy(), tx.numpy(), tc.numpy()
    np.testing.assert_allclose(jp, tp, atol=1e-4)
    np.testing.assert_allclose(jx, tx, atol=1e-4)
    np.testing.assert_array_equal(np.isinf(jc), np.isinf(tc))
    fin = np.isfinite(tc)
    np.testing.assert_allclose(jc[fin], tc[fin], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(np.isinf(tc), ~a["valid"])
    # it optimizes: fixed cameras untouched, the others pulled to the truth
    np.testing.assert_array_equal(tp[n_opt:], a["poses"][n_opt:])
    err0 = np.linalg.norm(a["poses"][:n_opt, 4:] - poses_gt[:n_opt, 4:], axis=1).mean()
    err1 = np.linalg.norm(tp[:n_opt, 4:] - poses_gt[:n_opt, 4:], axis=1).mean()
    if case != "truncated_lists":  # a truncated list drops observations from the Schur part
        assert err1 < 0.3 * err0, (err0, err1)


def test_indefinite_system_rejects_the_step():
    """A reduced system that is not positive definite must give a rejected
    LM step (state unchanged), not an exception.  Negative information
    weights make H, and so the reduced system, negative definite."""
    a, _, _, n_opt = make_problem(seed=7)
    a["inv_s2"] = -np.abs(a["inv_s2"])  # negative information: H is negative definite
    tp, tx, tc = tba.bundle_adjust(_torch_problem(a), torch.tensor(K), n_opt=n_opt, iters=3,
                                   huber=False)
    np.testing.assert_array_equal(tp.numpy(), a["poses"])  # every step rejected
    np.testing.assert_array_equal(tx.numpy(), a["points"])
    jp, jx, _ = jba.bundle_adjust(_jax_problem(a), jnp.asarray(K), n_opt=n_opt, iters=3,
                                  huber=False)
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jx), tx.numpy(), atol=1e-5)
