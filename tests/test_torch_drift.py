"""Twins of tests/test_linalg_small.py::TestDriftAnalysis on the port's
``utils/evaluate.py::drift_analysis``, the same trajectories through both
packages' functions.

Both are numpy code (the port keeps its own copy of the reference's module),
so the bar is equality: every number of the returned dicts equal.  Each
test also makes the reference test's own asserts on the port's result.
"""

import numpy as np

from asdslam_tpu.utils import evaluate as jeval
from asdslam_torch.utils import evaluate as teval


def _traj(n=400):
    t = np.linspace(0, 4 * np.pi, n)
    return np.stack([30 * np.cos(t), np.zeros_like(t), 30 * np.sin(t)], 1)


def _both(est, gt):
    j, t = jeval.drift_analysis(est.copy(), gt), teval.drift_analysis(est.copy(), gt)
    assert t == j
    return t


def test_perfect_trajectory_reports_no_drift():
    gt = _traj()
    d = _both(gt.copy(), gt)
    assert d["scale_drift_pct"] < 0.5
    assert all(s["local_rmse_m"] < 1e-3 for s in d["segments"])
    assert d["error_curve"][-1]["err_m"] < 1e-2


def test_progressive_scale_drift_detected():
    gt = _traj()
    # the estimate shrinks 20% linearly over the run (monocular scale drift)
    est = gt * np.linspace(1.0, 0.8, len(gt))[:, None]
    d = _both(est, gt)
    assert d["scale_drift_pct"] > 3.0, d["scale_drift_pct"]
    assert max(c["err_m"] for c in d["error_curve"]) > 1.0


def test_local_noise_vs_drift_separation():
    gt = _traj()
    est = gt + np.random.default_rng(0).normal(0, 0.05, gt.shape)
    d = _both(est, gt)
    assert d["scale_drift_pct"] < 2.0
    med = np.median([s["local_rmse_m"] for s in d["segments"]])
    assert 0.01 < med < 0.15
