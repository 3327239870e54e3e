"""Bundle adjustment: motion-only (PoseOptimization parity,
Optimizer.cc:239-413) and full BA with a Schur complement
(BundleAdjustment / LocalBundleAdjustment, Optimizer.cc:43-237, 415-735).

Port of ``asdslam_tpu/backend/ba.py``.  ``pose_only_optimize``: ``rounds``
rounds of ``iters`` Levenberg-Marquardt steps, Huber sqrt(5.991) in every
round but the last, chi2 outlier gating between rounds on the 2-DoF 95%
quantile.  ``bundle_adjust``: LM over ``n_opt`` cameras and all valid points,
landmarks marginalized per point, the reduced camera system solved densely
by Cholesky.  Every accumulation of its step is a gather or a one-hot
contraction, never a scatter-add: on a CUDA device ``index_add_`` sums with
atomics in an order that changes from run to run, and the port's results are
bitwise equal run to run.

Residual convention: r = project(R_cw X + t_cw) - uv_observed, weighted by
inv_sigma2 of the keypoint's pyramid level.  The pose update is
left-multiplicative (exp(xi) * T), as ``se3.pose_retract``.

The reference runs the LM steps in a ``lax.scan``; here they are a Python
loop whose accept/reject is decided on device, so the solve never waits on
the host.  On the card each LM step of ``bundle_adjust`` is replayed from a
CUDA graph (``utils/graphs.py``), and each LM iteration and chi2 gate of
``pose_only_optimize`` is one hand-written kernel (``ops/pose_lm.py``,
``csrc/pose_lm.cu``), launched inside the fused step's graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from asdslam_torch.estimators.linalg import inv3x3
from asdslam_torch.geometry import se3
from asdslam_torch.geometry.reprojection import CHI2_MONO, Obs
from asdslam_torch.geometry.reprojection import huber_weight as _huber_weight
from asdslam_torch.geometry.reprojection import project_residuals as _project_residuals
from asdslam_torch.ops import pose_lm
from asdslam_torch.utils import graphs


def pose_only_optimize(
    pose7, points, uv, inv_sigma2, valid, K,
    rounds: int = 4, iters: int = 10, chi2_th: float = CHI2_MONO,
    huber: bool = True,
):
    """Optimize a single camera pose against fixed 3D points.

    pose7: [7]; points: [N, 3] world; uv: [N, 2]; valid: [N] bool.
    Returns (pose7_opt, inlier_mask [N], n_inliers int32).  Observations with
    chi2 > chi2_th are outliers for the next round and re-enter if their
    error drops below the gate, as in the reference.

    Each LM iteration is one ``ops/pose_lm.py::pose_lm_step`` and each gate
    one ``pose_lm_gate`` (one kernel launch each on CUDA tensors); the
    first gate, with gating off, gives the first round's starting cost:
    1 + rounds * (iters + 1) calls.
    """
    inliers, cost = pose_lm.pose_lm_gate(pose7, points, uv, inv_sigma2, valid, K, chi2_th,
                                         gate=False)
    pose = pose7
    for rd in range(rounds):
        use_huber = huber and rd < rounds - 1  # last round: plain kernel (g2o parity)
        lam = torch.full((), 1e-3, dtype=pose.dtype, device=points.device)  # no host copy
        for _ in range(iters):
            pose, lam, cost = pose_lm.pose_lm_step(pose, lam, cost, points, uv, inv_sigma2,
                                                   inliers, K, use_huber)
        inliers, cost = pose_lm.pose_lm_gate(pose, points, uv, inv_sigma2, valid, K, chi2_th)

    return pose, inliers, torch.sum(inliers, dtype=torch.int32)


# --------------------------------------------------------------------------- #
# Full BA with Schur complement
# --------------------------------------------------------------------------- #
class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    poses7:   [C, 7] all cameras (optimized first, then fixed anchors)
    points:   [P, 3]
    pt_valid: [P] bool
    obs:      Obs (cam_idx into poses7, pt_idx into points)
    pt_obs:   [P, Kmax] int64 — indices into obs of each point's
              observations (-1 pad); host-assembled
    """

    poses7: torch.Tensor
    points: torch.Tensor
    pt_valid: torch.Tensor
    obs: Obs
    pt_obs: torch.Tensor


def build_pt_obs(pt_idx, valid, n_points: int, k_max: int):
    """Host helper (numpy): [P, Kmax] int32 table of observation indices per
    point, -1 padded.  Vectorized."""
    import numpy as np

    pt_idx = np.asarray(pt_idx)
    valid = np.asarray(valid)
    rows = np.nonzero(valid & (pt_idx >= 0) & (pt_idx < n_points))[0]
    p = pt_idx[rows]
    order = np.argsort(p, kind="stable")
    rows, p = rows[order], p[order]
    first = np.searchsorted(p, np.arange(n_points))
    rank = np.arange(len(p)) - first[p]
    keep = rank < k_max
    table = np.full((n_points, k_max), -1, np.int32)
    table[p[keep], rank[keep]] = rows[keep]
    return table


# Per-camera trust region default (tangent units per LM iteration).  The
# tuned pipeline (local BA windows, post-essential-graph GBA) is validated
# with 2.0; callers needing legitimately large corrections should raise it:
# total camera motion is capped at iters * trust_region.
CAM_TRUST_REGION = 2.0


def _total_cost(poses7, points, obs, K, obs_w_valid, huber: bool):
    delta2 = CHI2_MONO
    r, _, _, z = _project_residuals(poses7, points, obs, K)
    chi2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    if huber:
        chi2 = torch.where(
            chi2 <= delta2, chi2,
            2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
    return torch.sum(chi2 * obs_w_valid)


def _lm_iteration(poses7, points, lam, cost, obs, K, pt_w, obs_w_valid, po, po_valid,
                  cam_p, cam_is_opt, ohk, opt_cam, oh_cam_mask, n_opt: int, huber: bool,
                  trust_region: float):
    """One LM step of ``bundle_adjust``: (poses7, points, lam, cost) after
    it.  The per-call invariants (the per-point observation lists and the
    one-hot camera tables) are arguments, so one graph serves every call of
    the same bucketed shapes: it is captured in a CUDA graph on the card
    (``_lm_step``)."""
    dev, dt = points.device, points.dtype
    delta2 = CHI2_MONO
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye_s = torch.eye(n_opt * 6, dtype=dt, device=dev)

    r, Jc, Jp, z = _project_residuals(poses7, points, obs, K)
    chi2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    w_h = _huber_weight(chi2, delta2) if huber else torch.ones_like(chi2)
    w = obs.inv_sigma2 * w_h * obs_w_valid
    wc = w * opt_cam

    # camera blocks: one-hot over the few optimized cameras
    oh_cam = oh_cam_mask * wc[:, None]                         # [O, A]
    JcJc = torch.einsum("oki,okj->oij", Jc, Jc)
    Hcc = torch.einsum("oa,oij->aij", oh_cam, JcJc)
    Jcr = torch.einsum("oki,ok->oi", Jc, r)
    gc = torch.einsum("oa,oi->ai", oh_cam, Jcr)

    # point blocks: gather each point's observations via pt_obs
    w_p = w[po] * po_valid                                     # [P, K]
    Jp_p = Jp[po]                                              # [P, K, 2, 3]
    r_p = r[po]
    Hpp = torch.einsum("pkli,pk,pklj->pij", Jp_p, w_p, Jp_p)
    gp = torch.einsum("pkli,pk,pkl->pi", Jp_p, w_p, r_p)

    # LM damping: H += lam * diag(H)
    dcc = torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-6)
    Hcc = Hcc + lam * dcc[:, :, None] * eye6[None]
    dpp = torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
    Hpp_d = Hpp + lam * dpp[:, :, None] * eye3[None] + 1e-8 * eye3[None]
    Hpp_inv = inv3x3(Hpp_d)
    Hpp_inv = torch.where(pt_w[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))

    # W blocks per observation: [O, 6, 3]
    W = torch.einsum("oki,o,okj->oij", Jc, wc, Jp)

    # Schur assembly over per-point observation lists: per-point
    # per-camera sums via a small one-hot contraction, then the double sum
    #     S[a, b] = sum_p (sum_{k->a} WHinv_k)(sum_{m->b} W_m)^T
    # as one dense contraction over (p, l).
    W_p = W[po] * po_valid[..., None, None]                   # [P, Kmax, 6, 3]
    WHinv = torch.einsum("pkij,pjl->pkil", W_p, Hpp_inv)      # [P, Kmax, 6, 3]
    camA = torch.einsum("pka,pkil->ailp", ohk, WHinv)         # [A, 6, 3, P]
    camB = torch.einsum("pka,pkil->ailp", ohk, W_p)
    S = torch.einsum("ailp,bjlp->abij", camA, camB)           # [A, A, 6, 6]
    S_full = S.permute(0, 2, 1, 3).reshape(n_opt * 6, n_opt * 6)
    Hcc_full = torch.block_diag(*Hcc.unbind(0))

    # rhs: gc - sum_p W Hpp^-1 gp
    rhs = gc - torch.einsum("ailp,pl->ai", camA, gp)

    S_red = Hcc_full - S_full + 1e-8 * eye_s
    # S_red is SPD (damped Schur complement of an SPD system).  A
    # numerically indefinite edge case gives NaN dc, and the LM candidate
    # is simply rejected (new_cost < cost is false): cholesky_ex reports
    # the failure in `info` instead of raising.
    L, info = torch.linalg.cholesky_ex(S_red)
    dc = -torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(n_opt, 6)
    dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
    # per-camera trust region: weakly-observed cameras are rank-deficient
    # and their junk updates ride along with cost-improving steps (the
    # LM gate only sees the total), so clip each camera's tangent step
    dc_norm = torch.linalg.norm(dc, dim=1, keepdim=True)
    dc = dc * torch.clamp(trust_region / torch.clamp(dc_norm, min=1e-9), max=1.0)

    # back-substitute points: dp = -Hpp^-1 (gp + W^T dc), gathered
    dc_k = dc[cam_p] * cam_is_opt[..., None]                  # [P, K, 6]
    WT_dc = torch.einsum("pkij,pki->pj", W_p, dc_k)           # [P, 3]
    dp = -torch.einsum("pij,pj->pi", Hpp_inv, gp + WT_dc)
    dp = torch.where(pt_w[:, None], dp, torch.zeros_like(dp))

    # candidate update
    new_opt = se3.pose_retract(poses7[:n_opt], dc)
    cand_poses = torch.cat([new_opt, poses7[n_opt:]], dim=0)
    cand_points = points + dp
    new_cost = _total_cost(cand_poses, cand_points, obs, K, obs_w_valid, huber)
    accept = new_cost < cost
    poses7 = torch.where(accept, cand_poses, poses7)
    points = torch.where(accept, cand_points, points)
    lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9),
                      torch.clamp(lam * 5.0, max=1e8))
    cost = torch.where(accept, new_cost, cost)
    return poses7, points, lam, cost


_lm_step = graphs.captured(_lm_iteration, "local_ba")


def bundle_adjust(
    problem: BAProblem, K, n_opt: int,
    iters: int = 10, huber: bool = True, chi2_th: float = CHI2_MONO,
    trust_region: float = CAM_TRUST_REGION,
):
    """LM bundle adjustment over `n_opt` cameras + all valid points.

    Returns (poses7 [C, 7], points [P, 3], obs_chi2 [O]).
    Landmarks are marginalized per-point (Schur); the reduced camera system
    [6*n_opt, 6*n_opt] is solved densely.  The LM steps are a Python loop
    whose accept/reject is a ``torch.where`` on device; each is
    ``_lm_step``, replayed from a CUDA graph on the card.
    """
    poses7 = problem.poses7
    points = problem.points
    obs = problem.obs
    dev, dt = points.device, points.dtype
    O = obs.uv.shape[0]

    obs_w_valid = obs.valid.to(dt)
    cam_idx = obs.cam_idx.to(torch.int64)
    obs = obs._replace(cam_idx=cam_idx, pt_idx=obs.pt_idx.to(torch.int64))
    pt_obs = problem.pt_obs.to(torch.int64)
    ar_opt = torch.arange(n_opt, device=dev)

    # loop invariants of the step: the per-point observation lists
    po = torch.clamp(pt_obs, 0, O - 1)
    po_valid = pt_obs >= 0
    cam_po = cam_idx[po]
    cam_p = torch.clamp(cam_po, 0, n_opt - 1)                   # [P, Kmax]
    cam_is_opt = (cam_po < n_opt) & po_valid
    ohk = ((cam_p[..., None] == ar_opt) & cam_is_opt[..., None]).to(dt)  # [P, K, A]
    opt_cam = (cam_idx < n_opt).to(dt)
    oh_cam_mask = (cam_idx[:, None] == ar_opt[None, :]).to(dt)  # [O, A]

    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = _total_cost(poses7, points, obs, K, obs_w_valid, huber)
    for _ in range(iters):
        poses7, points, lam, cost = _lm_step(
            poses7, points, lam, cost, obs, K, problem.pt_valid, obs_w_valid, po, po_valid,
            cam_p, cam_is_opt, ohk, opt_cam, oh_cam_mask, n_opt, huber, trust_region)

    r, _, _, z = _project_residuals(poses7, points, obs, K)
    chi2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    chi2 = torch.where(obs.valid & (z > 0), chi2, torch.full_like(chi2, float("inf")))
    return poses7, points, chi2
