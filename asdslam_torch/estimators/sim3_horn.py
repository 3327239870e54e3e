"""Horn 1987 closed-form Sim(3) alignment + batched RANSAC.

Port of ``asdslam_tpu/estimators/sim3_horn.py``, which replaces
src/vslam/src/Sim3Solver.cc: 3-point RANSAC similarity estimate between
matched 3D point sets of a loop keyframe pair, verified by reprojection in
both images.  All hypotheses are solved and scored in one batched program
(RANSAC params 0.99/20/300 from LoopClosing.cc:313 arrive via SlamConfig).

Horn's method: rotation from the dominant eigenvector of the 4x4 quaternion
correlation matrix N (cyclic Jacobi), scale from the symmetric ratio of
deviations (Horn eq. 39, Sim3Solver::ComputeSim3's mono path), translation
from centroids.

Differences from the reference, none of them in results:

- the RANSAC draw matrix ``g`` [iters, N] (uniform in [0, 1)) is an
  argument; the caller makes it (``LoopCloser`` from a CPU generator seeded
  with the keyframe id), so a test can replay the JAX draws;
- ``lax.top_k`` and ``jnp.argmax`` keep the lower index on ties; here a
  stable descending sort and the first index of the maximum do the same;
- the LM and Gauss-Newton loops (``lax.scan`` there) are Python loops of
  fixed length whose accept/reject is a ``torch.where`` on the device, and
  the Jacobians come from ``torch.func.jacfwd`` as the reference's from
  ``jax.jacfwd``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from asdslam_torch.estimators import linalg
from asdslam_torch.estimators.twoview import pick
from asdslam_torch.geometry import se3, sim3
from asdslam_torch.ops.match import _top_indices
from asdslam_torch.utils import graphs


def horn_sim3(P1, P2, w=None):
    """Least-squares Sim3 (s, R, t) with P2 ~ s R P1 + t.

    P1, P2: [..., N, 3] matched points; w: optional [..., N] weights.
    Batched over leading dims.
    """
    if w is None:
        w = torch.ones(P1.shape[:-1], dtype=P1.dtype, device=P1.device)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    c1 = torch.sum(P1 * wn[..., None], dim=-2)
    c2 = torch.sum(P2 * wn[..., None], dim=-2)
    X = (P1 - c1[..., None, :]) * wn[..., None]
    Y = P2 - c2[..., None, :]
    M = torch.einsum("...ni,...nj->...ij", X, Y)  # [..., 3, 3]: M[a,b] = sum x_a y_b

    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
    ], dim=-2)
    _, V = linalg.jacobi_eigh(N)
    q = V[..., :, 0]  # dominant eigenvector = optimal quaternion (w, x, y, z)
    R = se3.quat_to_matrix(q)

    # scale: symmetric Horn: s = sqrt(sum|y|^2 / sum|x|^2) with weights
    num = torch.sum(torch.sum(Y * Y, dim=-1) * wn, dim=-1)
    den = torch.sum(torch.sum((P1 - c1[..., None, :]) ** 2, dim=-1) * wn, dim=-1)
    s = torch.sqrt(num / torch.clamp(den, min=1e-12))
    t = c2 - s[..., None] * torch.einsum("...ij,...j->...i", R, c1)
    return s, R, t


def _project(K, p):
    z = torch.where(torch.abs(p[..., 2]) < 1e-9, torch.full_like(p[..., 2], 1e-9), p[..., 2])
    return torch.stack([K[0, 0] * p[..., 0] / z + K[0, 2],
                        K[1, 1] * p[..., 1] / z + K[1, 2]], dim=-1)


def refine_sim3(s0, R0, t0, P1, P2, uv1, uv2, valid, K,
                inv_sigma2_1, inv_sigma2_2,
                iters: int = 10, fix_scale: bool = False,
                chi2_th: float = 9.21):
    """GN refinement of a Sim3 (P2-frame = S(P1-frame)) minimizing two-way
    pixel reprojection — Optimizer::OptimizeSim3 parity (Optimizer.cc:1002+),
    with chi2 outlier down-weighting.  Jacobians by forward-mode autodiff on
    the left-multiplicative sim3 tangent.  Returns (s, R, t, inlier_mask)."""
    dev, dt = P1.device, P1.dtype
    pose0 = sim3.sim3_pack(torch.as_tensor(s0, dtype=dt, device=dev).reshape(()), R0, t0)
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]
    N = P1.shape[0]

    def residuals(packed):
        # a batch of one: under forward-mode AD a 0-d tensor times a Python
        # float takes a float64 tangent, a [1] tensor does not
        s, R, t = sim3.sim3_unpack(packed.reshape(1, 8))  # s [1]
        p2h = sim3.transform(s, R, t, P1)
        si, Ri, ti = sim3.inverse(s, R, t)
        p1h = sim3.transform(si, Ri, ti, P2)
        r2 = (_project(K, p2h) - uv2) * sq2
        r1 = (_project(K, p1h) - uv1) * sq1
        return torch.cat([r1, r2], dim=0)  # [2N, 2]

    def chi2_of(packed):
        r = residuals(packed)
        return torch.sum(r[:N] ** 2, dim=1) + torch.sum(r[N:] ** 2, dim=1)

    w_obs = valid.to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    packed, lam = pose0, torch.full((), 1e-4, dtype=dt, device=dev)  # no host copy
    for _ in range(iters):
        chi2 = chi2_of(packed)
        w_in = (chi2 <= chi2_th).to(dt)
        w2 = torch.cat([w_obs, w_obs]) * torch.cat([w_in, w_in])

        def r_of(xi, packed=packed):
            return residuals(sim3.retract(packed[None], xi[None]))

        z = torch.zeros(7, dtype=dt, device=dev)
        r = r_of(z)
        J = jacfwd(r_of)(z)  # [2N, 2, 7]
        if fix_scale:
            J = torch.cat([J[..., :6], torch.zeros_like(J[..., 6:])], dim=-1)
        H = torch.einsum("oki,o,okj->ij", J, w2, J) + (lam + 1e-8) * eye7
        g = torch.einsum("oki,o,ok->i", J, w2, r)
        dx = -linalg.chol_solve_small(H, g)
        if fix_scale:
            dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
        cand = sim3.retract(packed, dx)
        better = torch.sum(chi2_of(cand) * w_obs) < torch.sum(chi2 * w_obs)
        packed = torch.where(better, cand, packed)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    s, R, t = sim3.sim3_unpack(packed)
    inl = valid & (chi2_of(packed) <= chi2_th)
    return s, R, t, inl


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def ransac_sim3(g, P1, P2, uv1, uv2, valid, K, chi2_px1, chi2_px2,
                min_inliers: int = 20, fix_scale: bool = False):
    """Batched-hypothesis RANSAC Horn alignment.

    g: [iters, N] uniform draws in [0, 1) (the reference draws them inside
    from its key); P1, P2: [N, 3] matched 3D points in the two camera frames;
    uv1, uv2: [N, 2] their pixel observations in each keyframe; chi2_px*:
    [N] per-match squared-pixel thresholds (9.210 * sigma2 of the keypoint
    octave — Sim3Solver.cc:141-144).  The inlier check mirrors
    Sim3Solver::CheckInliers: project P2 through S12 into image 1 and P1
    through S21 into image 2.
    """
    g = torch.where(valid[None, :], g, torch.full_like(g, -1.0))
    # top-3 per row, ties to the lower index (lax.top_k's order)
    samples = torch.sort(g, dim=1, descending=True, stable=True).indices[:, :3]

    s_h, R_h, t_h = horn_sim3(P1[samples], P2[samples])  # hypothesis: P2 = S21(P1)
    if fix_scale:
        s_h = torch.ones_like(s_h)

    def count_inliers(s, R, t):
        # S21: cam1 -> cam2
        p2h = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, P1) + t[..., None, :]
        # S12 = inverse
        Rt = R.transpose(-1, -2)
        si = 1.0 / s
        ti = -torch.einsum("...ij,...j->...i", Rt, t) / s[..., None]
        p1h = si[..., None, None] * torch.einsum("...ij,nj->...ni", Rt, P2) + ti[..., None, :]
        e2 = torch.sum((_project(K, p2h) - uv2) ** 2, dim=-1)
        e1 = torch.sum((_project(K, p1h) - uv1) ** 2, dim=-1)
        return (e1 < chi2_px1) & (e2 < chi2_px2) & valid

    inl = count_inliers(s_h, R_h, t_h)  # [iters, N]
    counts = torch.sum(inl, dim=1)
    best = _top_indices(counts, 1)[0]  # first maximum, as jnp.argmax

    # refit on the best hypothesis' inliers
    w = pick(inl, best).to(P1.dtype)
    s_r, R_r, t_r = horn_sim3(P1, P2, w)
    if fix_scale:
        s_r = torch.ones_like(s_r)
    inl_r = count_inliers(s_r[None], R_r[None], t_r[None])[0]
    use_refit = torch.sum(inl_r) >= pick(counts, best)
    s_f = torch.where(use_refit, s_r, pick(s_h, best))
    R_f = torch.where(use_refit, R_r, pick(R_h, best))
    t_f = torch.where(use_refit, t_r, pick(t_h, best))
    inl_f = torch.where(use_refit, inl_r, pick(inl, best))
    n = torch.sum(inl_f)
    return Sim3Result(success=n >= min_inliers, s=s_f, R=R_f, t=t_f,
                      inliers=inl_f, n_inliers=n)


def _optimize_sim3_align(X_src, X_dst, valid, iters: int = 20,
                         huber_delta: float = 0.5):
    """3D-3D Sim3 alignment of matched point sets — Optimizer::
    OptimizeSim3Align parity (src/vslam/src/Optimizer.cc:1196, 1355).

    Returns (s, R, t, inlier_mask) minimizing the robust 3D residual
    || s R x_src + t - x_dst ||.  Horn closed form seeds a GN refinement
    with Huber weighting."""
    dt, dev = X_src.dtype, X_src.device
    w0 = valid.to(dt)
    s, R, t = horn_sim3(X_src, X_dst, w=w0)
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def residuals(s, R, t):
        return s * X_src @ R.T + t - X_dst

    for _ in range(iters):
        r = residuals(s, R, t)
        nrm = torch.linalg.norm(r, dim=1)
        w_h = w0 * torch.where(nrm <= huber_delta, torch.ones_like(nrm),
                               huber_delta / torch.clamp(nrm, min=1e-9))

        def r_of(xi, s=s, R=R, t=t, w_h=w_h):
            # tangent: [3 rot, 3 trans, 1 log-scale]; [1]-shaped scalars,
            # as in refine_sim3
            dR = se3.so3_exp(xi[None, :3])[0]
            ds = torch.exp(xi[6:7])
            rr = (s * ds) * X_src @ (dR @ R).T + (t + xi[3:6]) - X_dst
            return (rr * w_h[:, None]).reshape(-1)

        J = jacfwd(r_of)(torch.zeros(7, dtype=dt, device=dev))
        r_w = (r * w_h[:, None]).reshape(-1)
        H = J.T @ J + 1e-8 * eye7
        dx = -linalg.chol_solve_small(H, J.T @ r_w)
        R_new = se3.so3_exp(dx[:3]) @ R
        s_new, t_new = s * torch.exp(dx[6]), t + dx[3:6]
        # accept only on (weighted) residual non-increase: chol_solve_small
        # clamps non-positive pivots, so an ill-conditioned f32 factorization
        # can produce a huge finite step — gate it instead of applying it
        cost_old = torch.sum((r * w_h[:, None]) ** 2)
        r_new = (s_new * X_src @ R_new.T + t_new - X_dst) * w_h[:, None]
        ok = torch.isfinite(dx).all() & (torch.sum(r_new ** 2) <= cost_old)
        s = torch.where(ok, s_new, s)
        R = torch.where(ok, R_new, R)
        t = torch.where(ok, t_new, t)
    r = residuals(s, R, t)
    inliers = valid & (torch.linalg.norm(r, dim=1) <= huber_delta)
    return s, R, t, inliers


# One program, as the reference jits it (asdslam_tpu/estimators/sim3_horn.py:202)
optimize_sim3_align = graphs.captured(_optimize_sim3_align, "sim3_align")
