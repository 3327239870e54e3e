"""Global bundle adjustment: implicit Schur complement + preconditioned CG.

Port of ``asdslam_tpu/backend/global_ba.py``, which replaces
Optimizer::BundleAdjustment / GlobalBundleAdjustemnt
(src/vslam/src/Optimizer.cc:43-237) at full-map scale.  The local-BA path
(backend/ba.py) assembles the reduced camera system densely, which is right
for a 16-camera window but not for thousands of keyframes; here S is never
materialized:

    S v = Hcc v - W Hpp^-1 W^T v

is evaluated per CG iteration with observation-indexed gathers and
per-point / per-camera sums, and the system is solved with block-Jacobi
preconditioned CG.

Every per-point and per-camera sum goes through a gather table
(``ba.build_pt_obs``: the observations of each point / camera, -1 padded)
and sums in the table's order, never a scatter-add, whose atomics would sum
in a run-dependent order on a CUDA device.  The caller passes the tables as
the reference's caller does; without them they are built here from one host
read of the observation table.  The LM steps and the PCG are Python loops of
fixed length whose accept/reject is a ``torch.where`` on the device; they read
nothing back (the preconditioner's inverse is ``inv_ex``, which checks no
error, so a singular block gives inf/NaN as ``jnp.linalg.inv`` does), and one
LM iteration with its PCG is captured in a CUDA graph on the card
(``utils/graphs.py``), as the reference compiles the whole solve.
"""

from __future__ import annotations

import numpy as np
import torch

from asdslam_torch.backend import ba
from asdslam_torch.estimators.linalg import inv3x3
from asdslam_torch.geometry import se3
from asdslam_torch.utils import graphs


def _table(idx, valid, n: int):
    """Gather table of the observations per entry (``ba.build_pt_obs``),
    from a host read of ``idx``, its width the largest count."""
    idx_np, valid_np = idx.cpu().numpy(), valid.cpu().numpy()
    counts = np.bincount(idx_np[valid_np & (idx_np >= 0) & (idx_np < n)], minlength=1)
    return torch.as_tensor(ba.build_pt_obs(idx_np, valid_np, n, max(int(counts.max()), 1))
                           ).to(idx.device)


def _seg(tab, tab_v, x):
    """Per-entry sums of per-observation values ``x`` through a gather
    table, in the table's order."""
    return torch.einsum("pk...,pk->p...", x[tab], tab_v)


def _total_cost(poses7, points, obs, K, obs_valid_f, huber: bool, delta2: float):
    r, _, _, z = ba._project_residuals(poses7, points, obs, K)
    chi2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    if huber:
        c = torch.where(chi2 <= delta2, chi2,
                        2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
    else:
        c = chi2
    return torch.sum(c * obs_valid_f)


def _lm_iteration(poses7, points, lam, cost, obs, K, pt_w, obs_valid_f, po, po_v, co, co_v,
                  n_opt: int, cg_iters: int, huber: bool, delta2: float, trust_region: float):
    """One LM iteration with its ``cg_iters`` PCG steps: (poses7, points,
    lam, cost) after it.  A function of tensors that reads nothing back, so
    it is captured in a CUDA graph on the card (``_lm_step``)."""
    dt, dev = points.dtype, points.device
    safe_cam = torch.clamp(obs.cam_idx, 0, n_opt - 1)
    opt_obs = obs.cam_idx < n_opt
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def seg_pt(x):
        return _seg(po, po_v, x)

    def seg_cam(x):
        return _seg(co, co_v, x)[:n_opt]

    r, Jc, Jp, z = ba._project_residuals(poses7, points, obs, K)
    chi2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    w_h = ba._huber_weight(chi2, delta2) if huber else torch.ones_like(chi2)
    w = obs.inv_sigma2 * w_h * obs_valid_f
    wc = w * opt_obs.to(dt)

    # block diagonals (per-point / per-camera sums via the gather tables)
    Hcc = seg_cam(torch.einsum("oki,o,okj->oij", Jc, wc, Jc))
    gc = seg_cam(torch.einsum("oki,o,ok->oi", Jc, wc, r))
    Hpp = seg_pt(torch.einsum("oki,o,okj->oij", Jp, w, Jp))
    gp = seg_pt(torch.einsum("oki,o,ok->oi", Jp, w, r))

    dcc = torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-6)
    Hcc_d = Hcc + lam * dcc[:, :, None] * eye6[None]
    dpp = torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
    Hpp_d = Hpp + lam * dpp[:, :, None] * eye3[None] + 1e-8 * eye3[None]
    Hpp_inv = inv3x3(Hpp_d)
    Hpp_inv = torch.where(pt_w[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))

    def schur_matvec(v):
        """v: [n_opt, 6] -> S v."""
        out = torch.einsum("cij,cj->ci", Hcc_d, v)
        # u_o = Jc_o v[cam_o] : [O, 2]
        u = torch.einsum("oki,oi->ok", Jc, v[safe_cam]) * opt_obs[:, None]
        # a_p = sum_o Jp^T w u : [P, 3]
        a = seg_pt(torch.einsum("oki,o,ok->oi", Jp, wc, u))
        b = torch.einsum("pij,pj->pi", Hpp_inv, a)
        # back out: per obs Jc^T w Jp b_p, accumulated per cam
        t = torch.einsum("oki,o,okj,oj->oi", Jc, wc, Jp, b[obs.pt_idx])
        return out - seg_cam(t)

    # rhs = gc - W Hpp^-1 gp
    hg = torch.einsum("pij,pj->pi", Hpp_inv, gp)
    t = torch.einsum("oki,o,okj,oj->oi", Jc, wc, Jp, hg[obs.pt_idx])
    rhs = -(gc - seg_cam(t))  # solve S dc = -rhs'

    # block-Jacobi preconditioner
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-8 * eye6[None]).inverse

    x = torch.zeros_like(rhs)
    rr = rhs - schur_matvec(x)
    zz = torch.einsum("cij,cj->ci", Minv, rr)
    p = zz
    for _ in range(cg_iters):
        Ap = schur_matvec(p)
        rz = torch.sum(rr * zz)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r_new = rr - alpha * Ap
        z_new = torch.einsum("cij,cj->ci", Minv, r_new)
        beta = torch.sum(r_new * z_new) / torch.clamp(rz, min=1e-20)
        p = z_new + beta * p
        rr, zz = r_new, z_new
    dc = x
    # per-camera trust region: a KF with 1-2 observations is
    # rank-deficient, so a junk multi-thousand-unit update can ride along
    # with a cost-improving step (the LM gate only sees the total)
    dc_norm = torch.linalg.norm(dc, dim=1, keepdim=True)
    dc = dc * torch.clamp(trust_region / torch.clamp(dc_norm, min=1e-9), max=1.0)

    # back-substitute points: per obs  w_o Jp_o^T (Jc_o dc[cam_o])
    u_dc = torch.einsum("oki,oi->ok", Jc, dc[safe_cam]) * opt_obs[:, None]
    WT_dc = seg_pt(torch.einsum("okj,o,ok->oj", Jp, wc, u_dc))
    dp = -torch.einsum("pij,pj->pi", Hpp_inv, gp + WT_dc)
    dp = torch.where(pt_w[:, None], dp, torch.zeros_like(dp))

    new_opt = se3.pose_retract(poses7[:n_opt], dc)
    cand_poses = torch.cat([new_opt, poses7[n_opt:]], dim=0)
    cand_points = points + dp
    new_cost = _total_cost(cand_poses, cand_points, obs, K, obs_valid_f, huber, delta2)
    accept = new_cost < cost
    poses7 = torch.where(accept, cand_poses, poses7)
    points = torch.where(accept, cand_points, points)
    lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-9),
                      torch.clamp(lam * 5.0, max=1e8))
    cost = torch.where(accept, new_cost, cost)
    return poses7, points, lam, cost


_lm_step = graphs.captured(_lm_iteration, "global_ba")


def global_bundle_adjust(
    poses7, points, pt_valid, obs: ba.Obs, K, n_opt: int,
    iters: int = 10, cg_iters: int = 50, huber: bool = True,
    chi2_th: float = 5.991, pt_obs=None, cam_obs=None,
    trust_region: float = ba.CAM_TRUST_REGION,
):
    """LM with implicit-Schur PCG.  First `n_opt` cameras optimized, rest
    fixed.  Returns (poses7, points, obs_chi2).

    pt_obs [P, Kp] / cam_obs [C, Kc]: per-point / per-camera
    observation-index tables (ba.build_pt_obs; -1 padded).  The setup is
    eager; each LM iteration is ``_lm_step``, replayed from a CUDA graph on
    the card."""
    P = points.shape[0]
    O = obs.uv.shape[0]
    dt, dev = points.dtype, points.device
    delta2 = chi2_th
    obs = obs._replace(cam_idx=obs.cam_idx.to(torch.int64), pt_idx=obs.pt_idx.to(torch.int64))
    obs_valid_f = obs.valid.to(dt)
    if pt_obs is None:
        pt_obs = _table(obs.pt_idx, obs.valid, P)
    if cam_obs is None:
        cam_obs = _table(obs.cam_idx, obs.valid & (obs.cam_idx < n_opt), n_opt)
    pt_obs, cam_obs = pt_obs.to(torch.int64), cam_obs.to(torch.int64)

    po = torch.clamp(pt_obs, 0, O - 1)
    po_v = (pt_obs >= 0).to(dt)
    co = torch.clamp(cam_obs, 0, O - 1)
    co_v = (cam_obs >= 0).to(dt)

    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = _total_cost(poses7, points, obs, K, obs_valid_f, huber, delta2)
    for _ in range(iters):
        poses7, points, lam, cost = _lm_step(
            poses7, points, lam, cost, obs, K, pt_valid, obs_valid_f, po, po_v, co, co_v,
            n_opt, cg_iters, huber, delta2, trust_region)

    r, _, _, z = ba._project_residuals(poses7, points, obs, K)
    chi2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    chi2 = torch.where(obs.valid & (z > 0), chi2, torch.full_like(chi2, float("inf")))
    return poses7, points, chi2
