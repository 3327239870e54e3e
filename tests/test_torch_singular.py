"""Singular and degenerate inputs at every small inverse and solve of the
port (``torch.linalg.inv_ex`` / ``solve_ex``), against the JAX package's
``jnp.linalg.inv`` / ``solve`` on the same inputs, on the CPU.

``jnp.linalg`` returns inf/NaN for a singular system where
``torch.linalg.inv`` / ``solve`` raise (and, on a CUDA tensor, wait for the
device to report).  Each test feeds one singular or degenerate input of
``chip_smoke.singular_inputs`` (which chip_smoke.py phase 13a runs on the
card against the CPU) to both functions and expects the same finiteness
pattern in every output, and the same values where they are finite, within
the bar stated at the test.  The bits of a singular inverse are not compared: two LU routines place their
inf/NaN differently (a rank-1 3x3 block inverts to some finite entries in
the port and to none in the reference), and what matters is what the
caller makes of it.

A ``gpu``-marked test counts the host synchronisations of the essential
graph's and global BA's LM loops on the card: one LM iteration and three
must make the same count, the setup's reads of the index tables alone.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asdslam_tpu.backend import global_ba as jgba
from asdslam_tpu.backend import ba as jba
from asdslam_tpu.backend import mapping_kernels as jmk
from asdslam_tpu.backend import pose_graph as jpg
from asdslam_tpu.estimators import linalg as jlinalg
from asdslam_tpu.estimators import pnp as jpnp
from asdslam_tpu.estimators import twoview as jtv
from asdslam_tpu.geometry import sim3 as jsim3
from asdslam_tpu.ops import match as jmatch
from asdslam_torch.backend import ba as tba
from asdslam_torch.backend import global_ba as tgba
from asdslam_torch.backend import mapping_kernels as tmk
from asdslam_torch.backend import pose_graph as tpg
from asdslam_torch.estimators import linalg as tlinalg
from asdslam_torch.estimators import pnp as tpnp
from asdslam_torch.estimators import twoview as ttv
from asdslam_torch.geometry import sim3 as tsim3
from asdslam_torch.ops import match as tmatch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# the inputs chip_smoke.py phase 13a runs on the card against the CPU
INPUTS = chip_smoke.singular_inputs()
K, K0, VALID = INPUTS["K"], INPUTS["K0"], INPUTS["valid"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.tensor(np.asarray(x))


def same_outputs(j, t, atol=0.0, rtol=0.0):
    """The same finiteness pattern (or the same values, for integer and
    boolean outputs), and finite values within atol + rtol * |j|."""
    j, t = np.asarray(j), t.detach().cpu().numpy()
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype.kind != "f":
        np.testing.assert_array_equal(t, j)
        return
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), fin)
    np.testing.assert_allclose(t[fin], j[fin], atol=atol, rtol=rtol)


def two_view(uv1, uv2, Kc, seed=0):
    key = jax.random.PRNGKey(seed)
    j = jtv.initialize_two_view(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(VALID),
                                jnp.asarray(Kc))
    g = np.asarray(jax.random.uniform(key, (200, len(VALID))))
    t = ttv.initialize_two_view(T(g), T(uv1), T(uv2), T(VALID), T(Kc))
    return j, t


def assert_two_view_refused(j, t):
    """Both refuse; the scores within test_initialize_two_view's bars
    (rtol 1e-4 for the chosen model, 2e-2 for the other, whose best
    hypothesis rounding decides); every other output the same pattern (R,
    t and the points mean nothing once refused, so their values are not
    compared)."""
    assert not bool(j.success) and not bool(t.success)
    assert bool(j.used_homography) == bool(t.used_homography)
    chosen = "score_h" if bool(t.used_homography) else "score_f"
    for field in ("score_h", "score_f"):
        same_outputs(getattr(j, field), getattr(t, field),
                     rtol=1e-4 if field == chosen else 2e-2)
    for field in ("R", "t", "points"):
        j_fin = np.isfinite(np.asarray(getattr(j, field)))
        np.testing.assert_array_equal(np.isfinite(getattr(t, field).numpy()), j_fin)
    np.testing.assert_array_equal(t.good.numpy(), np.asarray(j.good))


@pytest.mark.parametrize("pixel", INPUTS["pixels"])
def test_two_view_every_feature_at_one_pixel(pixel):
    """Every feature at one pixel in both images, all valid: every
    homography hypothesis is singular (twoview.py's _score_h inverts each).
    The reference refuses with finite scores; the port raised from
    torch.linalg.inv.  Measured: score_h 1198.2 and score_f 2396.4 at
    (0, 0), 3.1e-7 apart relative; both zero on both sides at (100, 50)."""
    uv = INPUTS["pixels"][pixel]
    assert_two_view_refused(*two_view(uv, uv, K))


def test_two_view_overflowing_pixel():
    """One feature of the second image at x = 3e38: the mean deviation of
    Hartley's normalisation overflows, its scale is 0, and T2 is singular
    (the inverse that maps the homographies back to pixels).  Both
    refuse."""
    assert_two_view_refused(*two_view(INPUTS["uv1"], INPUTS["uv_far"], K))


def test_score_h_singular_hypotheses():
    """_score_h over a zero, a rank-1, a regular and a rank-2 hypothesis:
    scores within 1e-4 relative (measured 7.5e-8), inlier masks equal."""
    H, uv1, uv2 = INPUTS["H"], INPUTS["uv1"], INPUTS["uv2"]
    js, jin = jtv._score_h(jnp.asarray(H), jnp.asarray(uv1), jnp.asarray(uv2),
                           jnp.asarray(VALID, jnp.float32), 1.0)
    ts, tin = ttv._score_h(T(H), T(uv1), T(uv2), T(VALID), 1.0)
    same_outputs(js, ts, rtol=1e-4)
    same_outputs(jin, tin)


def _triangulate_neighbors(Kc):
    tri = INPUTS["tri"]
    desc, uv, nb_desc, nb_uv = tri["desc"], tri["uv"], tri["nb_desc"], tri["nb_uv"]
    lvl, free = np.zeros(len(desc), np.int32), np.ones(len(desc), bool)
    eye, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    lut = np.ones(8, np.float32)
    kw = dict(max_dist=1.0, ratio=0.9, fmean=500.0)
    j = jmk.triangulate_neighbors(*map(jnp.asarray, (desc, uv, lvl, free, nb_desc[None],
                                                     nb_uv[None], lvl[None], free[None],
                                                     eye[None], tri["nb_t"][None], eye, z3,
                                                     Kc, lut)), **kw)
    t = tmk.triangulate_neighbors(T(desc), T(uv), T(lvl), T(free), [T(nb_desc)], [T(nb_uv)],
                                  [T(lvl)], T(free[None]), T(eye[None]), T(tri["nb_t"][None]),
                                  T(eye), T(z3), T(Kc), T(lut), **kw)
    return zip(j, t)


def _ransac_pnp(Kc):
    X, uv, chi2 = INPUTS["X"], INPUTS["uv1"], INPUTS["chi2"]
    key = jax.random.PRNGKey(1)
    j = jpnp.ransac_pnp(key, *map(jnp.asarray, (X, uv, VALID, Kc, chi2)))
    draws = np.asarray(jax.random.uniform(key, (300, len(VALID))))
    t = tpnp.ransac_pnp(*map(T, (draws, X, uv, VALID, Kc, chi2)))
    return zip(j, t)


def _fundamental(Kc):
    pose = INPUTS["poses"]
    return [(jmatch.fundamental_from_poses(*map(jnp.asarray, (Kc,) + pose)),
             tmatch.fundamental_from_poses(*map(T, (Kc,) + pose)))]


def _decompose_h(Kc):
    H = INPUTS["H_diag"]
    return zip(jtv._decompose_h(jnp.asarray(H), jnp.asarray(Kc)),
               ttv._decompose_h(T(H), T(Kc)))


def _two_view_outputs(Kc):
    assert_two_view_refused(*two_view(INPUTS["uv1"], INPUTS["uv2"], Kc))
    return []


INV_K_SITES = {
    "ops/match.py::fundamental_from_poses": _fundamental,
    "backend/mapping_kernels.py::triangulate_neighbors": _triangulate_neighbors,
    "estimators/pnp.py::ransac_pnp": _ransac_pnp,
    "estimators/twoview.py::_decompose_h": _decompose_h,
    "estimators/twoview.py::initialize_two_view": _two_view_outputs,
}


@pytest.mark.parametrize("site", INV_K_SITES)
def test_singular_intrinsics(site):
    """The constant inv(K) of each function, given a zero K: every output
    of both packages with the same pattern (all that depends on K
    non-finite, no match, no inlier, the two-view bootstrap refused)."""
    for j, t in INV_K_SITES[site](K0):
        same_outputs(j, t)


@pytest.mark.parametrize("case", INPUTS["pose_graph"])
def test_pose_graph_non_finite_measurement(case):
    """chip_smoke.pose_graph_problem_np's essential graph with one
    non-finite relative measurement, 3 LM iterations: the cost is
    non-finite, neither LM loop accepts a step, and both return the same
    poses (bar 1e-5, that of test_optimize_pose_graph; measured equal: both
    return the input poses)."""
    poses0, i_, j_, meas, w, fixed = INPUTS["pose_graph"][case]
    je = jpg.PoseGraphEdges(i=jnp.asarray(i_, jnp.int32), j=jnp.asarray(j_, jnp.int32),
                            meas=jnp.asarray(meas), weight=jnp.asarray(w),
                            valid=jnp.ones(len(w), bool))
    te = tpg.PoseGraphEdges(i=T(i_), j=T(j_), meas=T(meas), weight=T(w),
                            valid=torch.ones(len(w), dtype=torch.bool))
    jo = jpg.optimize_pose_graph(jnp.asarray(poses0), je, jnp.asarray(fixed), iters=3)
    to = tpg.optimize_pose_graph(T(poses0), te, T(fixed), iters=3)
    same_outputs(jo, to, atol=1e-5)


@pytest.mark.parametrize("case", INPUTS["global_ba"])
def test_global_ba_non_finite_input(case):
    """chip_smoke.gba_problem_np with one non-finite observation or point,
    3 LM iterations of 20 PCG iterations: both packages return the same
    poses and points (bar 2e-5, the small problem's of
    test_global_bundle_adjust; measured equal: no step is accepted) and the
    same chi2 pattern (chi2 within 1e-3 relative, that test's bar)."""
    poses0, X0, pt_valid, cam_idx, pt_idx, uv, inv_s2, valid, n_opt = INPUTS["global_ba"][case]
    jobs = jba.Obs(*map(jnp.asarray, (cam_idx, pt_idx, uv, inv_s2, valid)))
    jp, jx, jc = jgba.global_bundle_adjust(jnp.asarray(poses0), jnp.asarray(X0),
                                           jnp.asarray(pt_valid), jobs, jnp.asarray(K),
                                           n_opt=n_opt, iters=3, cg_iters=20)
    tobs = tba.Obs(*map(T, (cam_idx, pt_idx, uv, inv_s2, valid)))
    tp, tx, tc = tgba.global_bundle_adjust(T(poses0), T(X0), T(pt_valid), tobs, T(K),
                                           n_opt=n_opt, iters=3, cg_iters=20)
    same_outputs(jp, tp, atol=2e-5)
    same_outputs(jx, tx, atol=2e-5)
    same_outputs(jc, tc, atol=1e-3, rtol=1e-3)


def test_sim3_log_singular():
    """sim3_log at s = 0 and with an infinite or NaN translation, beside a
    regular case: the same pattern, finite values within test_sim3_ops'
    1e-5."""
    s, R, t = INPUTS["sim3"]
    same_outputs(jsim3.sim3_log(*map(jnp.asarray, (s, R, t))), tsim3.sim3_log(*map(T, (s, R, t))),
                 atol=1e-5, rtol=1e-4)


def test_inv3x3_singular_does_not_nan():
    """tests/test_linalg_small.py::TestInv3x3::test_singular_does_not_nan on
    both packages: a zero block inverts to finite values, the same ones."""
    A = INPUTS["zero_blocks"]
    j = np.asarray(jlinalg.inv3x3(jnp.asarray(A)))
    t = tlinalg.inv3x3(T(A))
    assert np.isfinite(t.numpy()).all()
    same_outputs(j, t)


@pytest.mark.gpu
def test_lm_loops_sync_free_on_cuda():
    """chip_smoke.lm_sync_counts on the card: the essential graph's and
    global BA's host synchronisations do not grow from 1 LM iteration to 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the host synchronisations are the card's")
    for name, by_iters in chip_smoke.lm_sync_counts("cuda").items():
        assert len(by_iters[1]) == len(by_iters[3]), (name, by_iters)
