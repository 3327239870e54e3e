"""Sim(3) pose-graph optimization (essential graph).

Port of ``asdslam_tpu/backend/pose_graph.py``, which replaces
Optimizer::OptimizeEssentialGraph (src/vslam/src/Optimizer.cc: 737-1000, g2o
BlockSolver_7_3): nodes are keyframe Sim3 poses S_iw, edges are
spanning-tree / loop / strong-covisibility constraints with measurements
S_ji = S_jw * S_iw^-1 captured at graph-build time.

Residual per edge: e(i, j) = sim3_log(S_meas_ji o S_iw o S_jw^-1), zero iff
the current relative pose matches the measurement.  Jacobians w.r.t. the
left-multiplicative tangents of both endpoints come from forward-mode
autodiff (``torch.func.jvp``, seven per endpoint over the batch of edges; the
reference vmaps ``jax.jacfwd`` over edges).

The reference scatter-adds each edge's blocks into its two nodes; here every
per-node sum is a gather through a [K, Kmax] incidence table built once per
call (one host read of the edge list), summed in a fixed order: on a CUDA
device a scatter-add sums with atomics in an order that changes from run to
run.  The PCG and the LM loop are Python loops of fixed length with no host
read inside.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp

from asdslam_torch.backend.ba import build_pt_obs
from asdslam_torch.geometry import sim3
from asdslam_torch.utils import graphs


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] int
    j: torch.Tensor       # [E] int
    meas: torch.Tensor    # [E, 8] packed sim3 measurement S_ji
    weight: torch.Tensor  # [E] scalar information weight
    valid: torch.Tensor   # [E] bool


def edge_residual(Si, Sj, meas):
    """e = log(meas_ji o S_i o S_j^-1) in R^7."""
    si, Ri, ti = sim3.sim3_unpack(Si)
    sj, Rj, tj = sim3.sim3_unpack(Sj)
    sm, Rm, tm = sim3.sim3_unpack(meas)
    sji, Rji, tji = sim3.compose(si, Ri, ti, *sim3.inverse(sj, Rj, tj))
    se, Re, te = sim3.compose(sm, Rm, tm, sji, Rji, tji)
    return sim3.sim3_log(se, Re, te)


def _e_of(xi_i, xi_j, Si, Sj, meas):
    """Residuals of a batch of edges [E, 7] at tangents xi_i, xi_j [E, 7]."""
    return edge_residual(sim3.retract(Si, xi_i), sim3.retract(Sj, xi_j), meas)


def edge_jacobians(Si, Sj, meas):
    """(e [E, 7], Ji [E, 7, 7], Jj [E, 7, 7]): each edge's residual and its
    Jacobians w.r.t. the left tangents of its two nodes at zero, by
    forward-mode autodiff (the reference's ``jax.jacfwd`` vmapped over
    edges): seven JVPs per endpoint on the whole batch of edges, with the
    edge axis as the functions' own batch axis."""
    E = Si.shape[0]
    z = torch.zeros((E, 7), dtype=Si.dtype, device=Si.device)
    eye = torch.eye(7, dtype=Si.dtype, device=Si.device)
    e = _e_of(z, z, Si, Sj, meas)
    Ji = torch.stack([jvp(lambda x: _e_of(x, z, Si, Sj, meas), (z,), (eye[c].expand(E, 7),))[1]
                      for c in range(7)], dim=-1)
    Jj = torch.stack([jvp(lambda x: _e_of(z, x, Si, Sj, meas), (z,), (eye[c].expand(E, 7),))[1]
                      for c in range(7)], dim=-1)
    return e, Ji, Jj


def _node_table(i, j, K: int):
    """(tab, live) [K, Kmax]: per node, the rows of ``cat([i, j])`` that
    touch it, in a host-built incidence table, and which entries are real.
    Edges whose endpoint is out of range are dropped, as the reference's
    ``mode="drop"``."""
    node = np.concatenate([i.cpu().numpy(), j.cpu().numpy()]).astype(np.int64)
    deg = np.bincount(node[(node >= 0) & (node < K)], minlength=K)
    kmax = max(int(deg.max()) if len(deg) else 1, 1)
    table = build_pt_obs(node, np.ones(len(node), bool), K, kmax)
    dev = i.device
    return (torch.as_tensor(np.clip(table, 0, None).astype(np.int64)).to(dev),
            torch.as_tensor(table >= 0).to(dev))


def _node_sum(tab, live, xi, xj):
    """[K, ...] per-node sums of per-edge values xi (at node i[e]) and xj
    (at node j[e]), in the order of the incidence table."""
    x = torch.cat([xi, xj], dim=0)[tab]                      # [K, kmax, ...]
    m = live.reshape(live.shape + (1,) * (x.ndim - 2)).to(x.dtype)
    return torch.sum(x * m, dim=1)


def _cost(poses8, ei, ej, meas, w):
    z7 = torch.zeros((ei.shape[0], 7), dtype=poses8.dtype, device=poses8.device)
    e = _e_of(z7, z7, poses8[ei], poses8[ej], meas)
    return torch.sum(torch.sum(e * e, dim=1) * w)


def _lm_iteration(poses8, lam_c, cost, ei, ej, tab, live, meas, w, free, fixedf,
                  cg_iters: int):
    """One LM iteration with its ``cg_iters`` PCG steps: (poses8, lam_c,
    cost) after it.  A function of tensors that reads nothing back, so it
    is captured in a CUDA graph on the card (``_lm_step``)."""
    K = poses8.shape[0]
    dev, dt = poses8.device, poses8.dtype
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def seg(xi, xj):
        return _node_sum(tab, live, xi, xj)

    e, Ji, Jj = edge_jacobians(poses8[ei], poses8[ej], meas)
    # edge-local GN blocks
    Hii = torch.einsum("eki,e,ekj->eij", Ji, w, Ji)
    Hjj = torch.einsum("eki,e,ekj->eij", Jj, w, Jj)
    Hij = torch.einsum("eki,e,ekj->eij", Ji, w, Jj)
    gi = torch.einsum("eki,e,ek->ei", Ji, w, e)
    gj = torch.einsum("eki,e,ek->ei", Jj, w, e)
    g = seg(gi, gj) * free[:, None]

    # diagonal blocks (damping + block-Jacobi preconditioner)
    D = seg(Hii, Hjj)
    dvec = torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-8)
    damp = lam_c * dvec + 1e-8                                # [K, 7]
    D_d = (D + damp[:, :, None] * eye7[None]) * free[:, None, None] \
        + fixedf[:, None, None] * eye7[None]
    # no error check, so no host read in the loop (jnp.linalg.inv's inf/NaN)
    Minv = torch.linalg.inv_ex(D_d).inverse

    def matvec(v):
        # H restricted to free nodes (rows+cols of fixed zeroed, unit
        # diagonal on fixed — matches the dense formulation)
        vf = v * free[:, None]
        vi = vf[ei]
        vj = vf[ej]
        yi = (torch.einsum("eij,ej->ei", Hii, vi)
              + torch.einsum("eij,ej->ei", Hij, vj))
        yj = (torch.einsum("eij,ej->ei", Hjj, vj)
              + torch.einsum("eji,ej->ei", Hij, vi))
        y = seg(yi, yj) + damp * vf
        return y * free[:, None] + v * fixedf[:, None]

    b = -g
    x = torch.zeros((K, 7), dtype=dt, device=dev)
    r = b
    z = torch.einsum("kij,kj->ki", Minv, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20,
                                 torch.full_like(denom, 1e-20), denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("kij,kj->ki", Minv, r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, torch.full_like(rz, 1e-20), rz)
        p = p * beta + z
        rz = rz_new
    dx = x * free[:, None]

    cand = sim3.retract(poses8, dx)
    new_cost = _cost(cand, ei, ej, meas, w)
    accept = new_cost < cost
    poses8 = torch.where(accept, cand, poses8)
    lam_c = torch.where(accept, torch.clamp(lam_c * 0.5, min=1e-9),
                        torch.clamp(lam_c * 4.0, max=1e4))
    cost = torch.where(accept, new_cost, cost)
    return poses8, lam_c, cost


_lm_step = graphs.captured(_lm_iteration, "essential_graph")


def optimize_pose_graph(poses8, edges: PoseGraphEdges, fixed_mask,
                        iters: int = 20, lam: float = 1e-6,
                        cg_iters: int = 150):
    """GN/LM over packed sim3 poses [K, 8].  fixed_mask [K] bool.

    The normal equations are never assembled densely: H v is evaluated
    edge-locally (two gathers + two [E, 7, 7] block products + per-node
    sums) inside a block-Jacobi-preconditioned CG.  The setup (the
    incidence table, one host read) is eager; each LM iteration is
    ``_lm_step``, replayed from a CUDA graph on the card.  Returns optimized
    poses8."""
    K = poses8.shape[0]
    dev, dt = poses8.device, poses8.dtype
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)
    tab, live = _node_table(ei, ej, K)
    free = (~fixed_mask).to(dt)
    fixedf = fixed_mask.to(dt)
    w = edges.weight * edges.valid.to(dt)

    lam_c = torch.tensor(lam, dtype=dt, device=dev)
    cost = _cost(poses8, ei, ej, edges.meas, w)
    for _ in range(iters):
        poses8, lam_c, cost = _lm_step(poses8, lam_c, cost, ei, ej, tab, live, edges.meas,
                                       w, free, fixedf, cg_iters)
    return poses8
