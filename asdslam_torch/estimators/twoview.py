"""Two-view monocular initialization: batched-hypothesis RANSAC for H and F,
model selection, and SE(3) reconstruction with cheirality checks.

Port of ``asdslam_tpu/estimators/twoview.py`` (Initializer.cc re-designed as
one batched program):

- ALL hypotheses for BOTH models are solved and scored at once (no early
  exit, fixed shapes);
- per-hypothesis 8-point/4-point systems are solved with inverse power
  iteration (estimators/linalg.py) instead of per-sample SVD;
- model selection keeps the rule RH = SH/(SH+SF) > 0.40
  (Initializer.cc:112-117);
- reconstruction: E = K^T F K decomposed via the iterative svd3; homography
  via Faugeras (ReconstructH, Initializer.cc:~760); the 12 candidate poses
  scored together (a leading batch axis) by triangulation +
  cheirality/parallax/reprojection (CheckRT, Initializer.cc:506+).

The one difference from the reference's signature: the RANSAC draws are an
argument.  ``initialize_two_view`` takes the uniform matrix ``g``
[iters, N] that the reference draws inside from its key, so the caller owns
the random stream (and a test can hand both packages the same draws).

All scoring constants mirror the reference: chi2 thresholds 3.841 (F
epipolar) / 5.991 (H transfer and F score cap), score increments
th_score - chi2, sigma from cfg.init_sigma.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from asdslam_torch.estimators import linalg
from asdslam_torch.geometry import triangulation

CHI2_F = 3.841
CHI2_H = 5.991
TH_SCORE = 5.991


class TwoViewResult(NamedTuple):
    success: torch.Tensor      # bool scalar
    used_homography: torch.Tensor
    R: torch.Tensor            # [3, 3] pose of view 2 w.r.t world(=view1)
    t: torch.Tensor            # [3]
    points: torch.Tensor       # [N, 3] triangulated points (world = cam1)
    good: torch.Tensor         # [N] bool: triangulated inlier
    score_h: torch.Tensor
    score_f: torch.Tensor


def first_argmax(x):
    """Index of the first maximum of a 1-D tensor (``jnp.argmax``'s choice;
    ``torch.argmax`` on a CUDA device does not promise it)."""
    return torch.sort(x, descending=True, stable=True).indices[0]


def pick(x, i):
    """``x[i]`` for a 0-d index tensor ``i``, gathered on the device:
    indexing with a 0-d tensor reads it back to the host, which no CUDA-graph
    capture can hold."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def sample_rows(g, valid, k: int):
    """[iters, k] sample indices from the draw matrix ``g`` [iters, N]: the k
    largest draws of each row among the valid columns, ties to the lower
    index (``jax.lax.top_k``'s order; masked entries are all -1.0)."""
    g = torch.where(valid[None, :], g, torch.full_like(g, -1.0))
    return torch.sort(g, dim=1, descending=True, stable=True).indices[:, :k]


def _clip_lo(x, lo):
    return torch.clamp(x, min=lo)


# --------------------------------------------------------------------------- #
# Hartley normalization
# --------------------------------------------------------------------------- #
def _normalize_points(x, valid):
    w = valid.to(x.dtype)
    n = _clip_lo(torch.sum(w), 1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    d = torch.abs(x - mean) * w[:, None]
    mean_dev = torch.sum(d, dim=0) / n
    s = 1.0 / _clip_lo(mean_dev, 1e-8)
    xn = (x - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one])])
    return xn, T


# --------------------------------------------------------------------------- #
# Model solvers (batched over hypotheses)
# --------------------------------------------------------------------------- #
def _f_rows(p1, p2):
    """Epipolar constraint rows x2^T F x1 = 0: [..., 9]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1
    )


def _h_rows(p1, p2):
    """DLT homography rows (2 per correspondence): [..., 2, 9]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    return torch.stack([r1, r2], dim=-2)


def _solve_f(p1, p2):
    """8-point fundamental from sampled points [S, 8, 2] x2 -> F [S, 3, 3]."""
    A = _f_rows(p1, p2)  # [S, 8, 9]
    f = linalg.null_vector(A)
    return f.reshape(f.shape[:-1] + (3, 3))


def _solve_h(p1, p2):
    """DLT homography from sampled points [S, 8, 2] x2 -> H [S, 3, 3]."""
    A = _h_rows(p1, p2).reshape(p1.shape[:-2] + (2 * p1.shape[-2], 9))
    h = linalg.null_vector(A)
    return h.reshape(h.shape[:-1] + (3, 3))


# --------------------------------------------------------------------------- #
# Scoring (CheckFundamental / CheckHomography parity)
# --------------------------------------------------------------------------- #
def _score(chi2_1, chi2_2, th, valid):
    ok1 = chi2_1 <= th
    ok2 = chi2_2 <= th
    zero = torch.zeros_like(chi2_1)
    sc = (torch.where(ok1, TH_SCORE - chi2_1, zero)
          + torch.where(ok2, TH_SCORE - chi2_2, zero))
    sc = sc * valid[None, :].to(sc.dtype)
    return torch.sum(sc, dim=1), ok1 & ok2 & valid[None, :]


def _score_f(F, x1, x2, valid, sigma):
    """F: [S, 3, 3]; x1, x2: [N, 2] pixels. Returns (score [S], inliers [S, N])."""
    h1 = triangulation.homog(x1)  # [N, 3]
    h2 = triangulation.homog(x2)
    inv_s2 = 1.0 / (sigma * sigma)

    l2 = torch.einsum("sij,nj->sni", F, h1)          # epipolar lines in im2
    num2 = torch.einsum("sni,ni->sn", l2, h2) ** 2
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    chi2_2 = num2 / _clip_lo(den2, 1e-12) * inv_s2

    l1 = torch.einsum("sji,nj->sni", F, h2)          # lines in im1 via F^T
    num1 = torch.einsum("sni,ni->sn", l1, h1) ** 2
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    chi2_1 = num1 / _clip_lo(den1, 1e-12) * inv_s2
    return _score(chi2_1, chi2_2, CHI2_F, valid)


def _dehomog(p):
    w = p[..., 2:]
    return p[..., :2] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def _score_h(H, x1, x2, valid, sigma):
    h1 = triangulation.homog(x1)
    h2 = triangulation.homog(x2)
    inv_s2 = 1.0 / (sigma * sigma)
    # a singular hypothesis inverts to inf/NaN and scores nothing, as in the
    # reference (torch.linalg.inv would raise)
    Hinv = torch.linalg.inv_ex(H).inverse

    p12 = _dehomog(torch.einsum("sij,nj->sni", H, h1))
    chi2_2 = torch.sum((p12 - x2[None]) ** 2, dim=-1) * inv_s2

    p21 = _dehomog(torch.einsum("sij,nj->sni", Hinv, h2))
    chi2_1 = torch.sum((p21 - x1[None]) ** 2, dim=-1) * inv_s2
    return _score(chi2_1, chi2_2, CHI2_H, valid)


# --------------------------------------------------------------------------- #
# Pose candidate scoring (CheckRT parity)
# --------------------------------------------------------------------------- #
def _check_rt(R, t, xn1, xn2, valid, sigma_norm, parallax_th=0.99998):
    """Triangulate all correspondences for each (R, t) candidate and count
    the good ones.  R [C, 3, 3], t [C, 3], valid [C, N]; xn*: [N, 2]
    normalized coords.  sigma_norm: pixel sigma / f.

    Returns (n_good [C], parallax_metric [C], good_mask [C, N],
    points [C, N, 3])."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    z3 = torch.zeros(3, dtype=R.dtype, device=R.device)
    Rb, tb = R[:, None], t[:, None]           # [C, 1, ...] against [N, ...]
    X = triangulation.triangulate_midpoint(eye, z3, Rb, tb, xn1, xn2)  # [C, N, 3]
    finite = torch.isfinite(X).all(dim=-1)
    X = torch.where(finite[..., None], X, torch.zeros_like(X))

    e1, z1 = triangulation.reprojection_error2(eye, z3, X, xn1)
    e2, z2 = triangulation.reprojection_error2(Rb, tb, X, xn2)
    c2 = -torch.einsum("cji,cj->ci", R, t)
    cosp = triangulation.parallax_cos(z3, c2[:, None], X)

    th2 = 4.0 * sigma_norm * sigma_norm
    # Cheirality kills a point only when parallax is meaningful: near-infinite
    # points jitter across z=0 and still COUNT toward nGood (reference
    # CheckRT, Initializer.cc:59-66 — `z<=0 && cosParallax<0.99998`).
    cheir = ((z1 > 0) | (cosp >= parallax_th)) & ((z2 > 0) | (cosp >= parallax_th))
    counted = valid & finite & cheir & (e1 < th2) & (e2 < th2)
    n_good = torch.sum(counted, dim=1, dtype=torch.int32)
    # only well-conditioned (parallax) points become map points
    # (vbGood, Initializer.cc:95-96)
    good = counted & (cosp < parallax_th) & (z1 > 0) & (z2 > 0)

    # parallax metric: cos at the 50th-best-parallax counted point (ref takes
    # the min(50, n)-th smallest cos)
    cos_masked = torch.where(counted, cosp, torch.ones_like(cosp))
    smallest = torch.sort(cos_masked, dim=1).values[:, :50]
    k = torch.clamp(torch.clamp(n_good, max=50) - 1, 0, 49).to(torch.int64)
    par_cos = torch.gather(smallest, 1, k[:, None])[:, 0]
    return n_good, par_cos, good, X


def _decompose_e(E):
    """E -> 4 candidate (R, t).  Iterative svd3; W-trick."""
    U, s, Vt = linalg.svd3(E[None])
    U, Vt = U[0], Vt[0]
    # enforce rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    # made on the device: a host-to-device copy could not be captured
    z, o = torch.zeros_like(E[0, 0]), torch.ones_like(E[0, 0])
    W = torch.stack([torch.stack([z, -o, z]), torch.stack([o, z, z]), torch.stack([z, z, o])])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tt = U[:, 2]
    tt = tt / _clip_lo(torch.linalg.norm(tt), 1e-12)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([tt, -tt, tt, -tt])
    return Rs, ts


def _decompose_h(H, K):
    """Faugeras 1988 homography decomposition -> 8 candidate (R, t).

    Mirrors Initializer::ReconstructH (Initializer.cc:~760): A = K^-1 H K,
    SVD(A) = U diag(d1,d2,d3) V^T, 8 solutions for d' = +-d2.
    """
    Kinv = torch.linalg.inv_ex(K).inverse
    A = Kinv @ H @ K
    U, s, Vt = linalg.svd3(A[None])
    U, Vt = U[0], Vt[0]
    V = Vt.T
    sdet = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = s[0, 0], s[0, 1], s[0, 2]
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def sqrt0(x):
        return torch.sqrt(_clip_lo(x, 0.0))

    aux1 = sqrt0((d1 * d1 - d2 * d2) / _clip_lo(d1 * d1 - d3 * d3, 1e-12))
    aux3 = sqrt0((d2 * d2 - d3 * d3) / _clip_lo(d1 * d1 - d3 * d3, 1e-12))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    z4, o4 = torch.zeros_like(x1s), torch.ones_like(x1s)

    # case d' = +d2
    aux_st = sqrt0((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / _clip_lo((d1 + d3) * d2, 1e-12)
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    ct = ((d2 * d2 + d1 * d3) / _clip_lo((d1 + d3) * d2, 1e-12)) * o4
    Rs_p = torch.stack([torch.stack([ct, z4, -st], -1),
                        torch.stack([z4, o4, z4], -1),
                        torch.stack([st, z4, ct], -1)], dim=-2)   # [4, 3, 3]
    tp = (d1 - d3) * torch.stack([x1s, z4, -x3s], dim=-1)

    # case d' = -d2
    aux_sp = sqrt0((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / _clip_lo((d1 - d3) * d2, 1e-12)
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    cp = ((d1 * d3 - d2 * d2) / _clip_lo((d1 - d3) * d2, 1e-12)) * o4
    Rs_n = torch.stack([torch.stack([cp, z4, sp], -1),
                        torch.stack([z4, -o4, z4], -1),
                        torch.stack([sp, z4, -cp], -1)], dim=-2)
    tn = (d1 + d3) * torch.stack([x1s, z4, x3s], dim=-1)

    Rs = torch.cat([Rs_p, Rs_n], dim=0)   # [8, 3, 3] (in A's frame)
    ts = torch.cat([tp, tn], dim=0)
    # map back: R = s U R' V^T, t = U t'
    Rs = sdet * torch.einsum("ij,njk,lk->nil", U, Rs, V)
    ts = torch.einsum("ij,nj->ni", U, ts)
    ts = ts / _clip_lo(torch.linalg.norm(ts, dim=-1, keepdim=True), 1e-12)
    return Rs, ts


# --------------------------------------------------------------------------- #
# Full initializer
# --------------------------------------------------------------------------- #
def _ransac_refit(solve, rows_all, score, to_pixels, samples, p1n, p2n):
    """RANSAC over the sampled hypotheses, then a least-squares refit on the
    best one's inliers (an improvement over the reference C++, which keeps
    the raw minimal model).  Returns (score, model / |model[2,2]|,
    inliers [N])."""
    models = to_pixels(solve(p1n[samples], p2n[samples]))
    scores, inl = score(models)
    i = first_argmax(scores)
    inliers0 = pick(inl, i)
    refit = linalg.null_vector(rows_all(inliers0)[None])[0].reshape(3, 3)
    M_refit = to_pixels(refit[None])[0]
    sc_r, inl_r = score(M_refit[None])
    better = sc_r[0] > pick(scores, i)
    S = torch.where(better, sc_r[0], pick(scores, i))
    best = torch.where(better, M_refit, pick(models, i))
    best = best / _clip_lo(torch.abs(best[2, 2]), 1e-12)
    return S, best, torch.where(better, inl_r[0], inliers0)


def initialize_two_view(
    g,
    uv1, uv2, valid,
    K,
    sigma: float = 1.0,
    min_triangulated: int = 50,
    min_parallax_cos: float = 0.9998476952,  # cos(1 deg)
):
    """Full two-view bootstrap from matched undistorted pixel coords.

    g: [iters, N] uniform draws in [0, 1), one row per RANSAC hypothesis;
    uv1, uv2: [N, 2]; valid: [N]; K: [3, 3] intrinsics.
    Returns TwoViewResult. (World frame = camera 1; |t| = 1 scale.)
    """
    fmean = 0.5 * (K[0, 0] + K[1, 1])

    # ---- sample hypothesis sets (8 distinct valid indices per hypothesis)
    samples = sample_rows(g, valid, 8)  # [iters, 8]

    p1n, T1 = _normalize_points(uv1, valid)
    p2n, T2 = _normalize_points(uv2, valid)
    T2inv = torch.linalg.inv_ex(T2).inverse

    # ---- fundamental.  No explicit rank-2 projection after the refit: it is
    # near rank-2 already and the E-decomposition zeroes sigma3 anyway.
    SF, bestF, f_inliers = _ransac_refit(
        _solve_f,
        lambda w: _f_rows(p1n, p2n) * w[:, None].to(p1n.dtype),
        lambda F: _score_f(F, uv1, uv2, valid, sigma),
        lambda Fn: torch.einsum("ji,sjk,kl->sil", T2, Fn, T1),  # T2^T Fn T1
        samples, p1n, p2n)

    # ---- homography (same RANSAC + inlier refit)
    SH, bestH, h_inliers = _ransac_refit(
        _solve_h,
        lambda w: (_h_rows(p1n, p2n) * w[:, None, None].to(p1n.dtype)).reshape(-1, 9),
        lambda H: _score_h(H, uv1, uv2, valid, sigma),
        lambda Hn: torch.einsum("ij,sjk,kl->sil", T2inv, Hn, T1),
        samples, p1n, p2n)

    use_h = SH / _clip_lo(SH + SF, 1e-12) > 0.40

    # ---- reconstruct both, select at the end (batched; no host branch)
    Kinv = torch.linalg.inv_ex(K).inverse
    xn1 = (triangulation.homog(uv1) @ Kinv.T)[:, :2]
    xn2 = (triangulation.homog(uv2) @ Kinv.T)[:, :2]
    sigma_norm = sigma / fmean

    E = K.T @ bestF @ K
    Rf, tf = _decompose_e(E)                     # [4]
    Rh, th = _decompose_h(bestH, K)              # [8]
    Rc = torch.cat([Rf, Rh], dim=0)              # [12, 3, 3]
    tc = torch.cat([tf, th], dim=0)
    inl = torch.cat([f_inliers[None].expand(4, -1), h_inliers[None].expand(8, -1)], dim=0)
    model_is_h = torch.arange(12, device=K.device) >= 4

    n_good, par_cos, good, X = _check_rt(Rc, tc, xn1, xn2, inl, sigma_norm)

    # restrict to the selected model's candidates
    active = torch.where(use_h, model_is_h, ~model_is_h)
    scores = torch.where(active, n_good, -1)
    best = first_argmax(scores)
    best_good = pick(scores, best)
    # Ambiguity check (ReconstructF/H nsimilar): evaluated on PARALLAX-VALID
    # triangulations only.  The counted total includes near-infinite points
    # whose cheirality is unknowable, and the twisted-pair wrong solution of
    # a planar/distant scene collects them freely — discriminating on
    # triangulable points keeps the reference's intent (reject genuinely
    # ambiguous reconstructions) without rejecting every street scene.
    n_tri = torch.sum(good, dim=1, dtype=torch.int32)
    tri_scores = torch.where(active, n_tri, -1)
    best_tri = pick(tri_scores, best)
    n_similar = torch.sum((tri_scores > 0.7 * best_tri) & (tri_scores > 0) & active)

    n_inl = torch.sum(torch.where(use_h, h_inliers, f_inliers), dtype=torch.int32)
    min_good = torch.clamp((0.9 * n_inl).to(torch.int32), min=min_triangulated)
    success = ((best_good >= min_good)
               & (n_similar == 1)
               & (pick(par_cos, best) < min_parallax_cos))

    return TwoViewResult(
        success=success,
        used_homography=use_h,
        R=pick(Rc, best), t=pick(tc, best),
        points=pick(X, best), good=pick(good, best),
        score_h=SH, score_f=SF,
    )
