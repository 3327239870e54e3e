"""Batched two-view triangulation + quality checks.

Port of ``asdslam_tpu/geometry/triangulation.py`` (the SVD triangulation
inside LocalMapping::CreateNewMapPoints and Initializer::Triangulate,
LocalMapping.cc:~430-540): the DLT solve as a batched 4x4 symmetric
eigendecomposition of A^T A, the eigen-free midpoint triangulator the hot
paths use, a Gauss-Newton point refinement, and the reprojection / parallax
checks.
"""

from __future__ import annotations

import torch


def homog(x):
    """[..., k] -> [..., k + 1] with a trailing 1."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def triangulate_dlt(P1, P2, x1, x2):
    """Triangulate normalized-coordinate correspondences.

    P1, P2: ``[..., 3, 4]`` projection matrices (typically [R|t] for
    normalized camera coords).
    x1, x2: ``[..., 2]`` normalized image coords in each view.
    Returns ``[..., 3]`` world points (homogeneous solution dehomogenized;
    the eigenvector's free sign cancels in the division).
    """
    A = torch.stack(
        [
            x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )  # [..., 4, 4]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)  # ascending eigenvalues
    X = vecs[..., :, 0]  # smallest
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def triangulate_midpoint(R1, t1, R2, t2, x1, x2):
    """Midpoint triangulation of normalized-coordinate correspondences.

    Poses are world->camera.  Solves the 2x2 least-squares for the depths
    along each ray and returns the segment midpoint.  Combined with
    ``refine_point_gn`` it is the hot-path triangulator.

    x1, x2: [..., 2] normalized coords.  Returns [..., 3] world points.
    """
    d1 = torch.einsum("...ji,...j->...i", R1, homog(x1))
    d2 = torch.einsum("...ji,...j->...i", R2, homog(x2))
    c1 = -torch.einsum("...ji,...j->...i", R1, t1)
    c2 = -torch.einsum("...ji,...j->...i", R2, t2)
    # normal equations for min ||(c1 + l1 d1) - (c2 + l2 d2)||:
    #   l1 (d1.d1) - l2 (d1.d2) = d1.(c2-c1)
    #   l1 (d1.d2) - l2 (d2.d2) = d2.(c2-c1)
    b = c2 - c1
    p = torch.sum(d1 * d1, dim=-1)
    q = torch.sum(d1 * d2, dim=-1)
    r = torch.sum(d2 * d2, dim=-1)
    b1 = torch.sum(d1 * b, dim=-1)
    b2 = torch.sum(d2 * b, dim=-1)
    det = q * q - p * r  # <= 0; zero only for parallel rays
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, -1e-12), det)
    l1 = (q * b2 - r * b1) / det
    l2 = (p * b2 - q * b1) / det
    p1 = c1 + l1[..., None] * d1
    p2 = c2 + l2[..., None] * d2
    return 0.5 * (p1 + p2)


def refine_point_gn(Rs, ts, xns, X0, valid=None, iters: int = 3):
    """Gauss-Newton refinement of a 3D point against multiple views.

    Rs, ts: [..., V, 3, 3], [..., V, 3] world->camera poses.
    xns:    [..., V, 2] normalized observations.
    X0:     [..., 3] initial point.  valid: [..., V] observation mask.
    """
    X = X0
    eye = torch.eye(3, dtype=X0.dtype, device=X0.device)
    for _ in range(iters):
        xc = torch.einsum("...vij,...j->...vi", Rs, X) + ts
        z = torch.clamp(xc[..., 2], min=1e-6)
        proj = xc[..., :2] / z[..., None]
        r = proj - xns  # [..., V, 2]
        # d proj / d X = [1/z, 0, -x/z^2; 0, 1/z, -y/z^2] @ R
        zi = 1.0 / z
        zero = torch.zeros_like(zi)
        J_proj = torch.stack(
            [
                torch.stack([zi, zero, -xc[..., 0] * zi * zi], dim=-1),
                torch.stack([zero, zi, -xc[..., 1] * zi * zi], dim=-1),
            ],
            dim=-2,
        )  # [..., V, 2, 3]
        J = J_proj @ Rs  # [..., V, 2, 3]
        if valid is not None:
            J = J * valid[..., None, None].to(X.dtype)
            r = r * valid[..., None].to(X.dtype)
        H = torch.einsum("...vki,...vkj->...ij", J, J)
        g = torch.einsum("...vki,...vk->...i", J, r)
        H = H + 1e-8 * eye
        X = X - torch.linalg.solve(H, g[..., None])[..., 0]
    return X


def reprojection_error2(R, t, X, xn):
    """Squared reprojection error in normalized coords for pose (R,t)."""
    xc = torch.einsum("...ij,...j->...i", R, X) + t
    z = xc[..., 2]
    zz = z[..., None]
    proj = xc[..., :2] / torch.where(torch.abs(zz) < 1e-12, torch.full_like(zz, 1e-12), zz)
    d = proj - xn
    return torch.sum(d * d, dim=-1), z


def parallax_cos(c1, c2, X):
    """Cosine of the ray angle at X subtended by camera centres c1, c2."""
    r1 = X - c1
    r2 = X - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
