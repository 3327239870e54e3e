"""Multi-device scaling: device meshes, data-parallel descriptor inference,
and distributed bundle adjustment by a Schur-complement reduction.

Port of ``asdslam_tpu/parallel/dist.py``.  The design is the reference's:

- Descriptor CNN: pure data parallelism.  The patch batch is split over the
  mesh's shards; no reduction in the forward.
- Distributed BA: POINT-MAJOR sharding.  Points are block-sharded over the
  mesh and every observation row lives on the shard that owns its point
  (``layout_point_major``, on the host).  Each shard holds COMPLETE
  landmark blocks: H_pp, g_p, the per-point camera aggregates and the
  landmark back-substitution never cross shards.  The only reductions are
  sums of the camera-side blocks, H_cc [C,6,6], g_c [C,6], the reduced
  Schur system S [C,C,6,6] and its rhs [C,6], so what crosses shards per
  Gauss-Newton step is O(C^2) whatever the point and observation counts.
  The reduced camera system is solved replicated.

The port's mesh (``Mesh``) is an ordered tuple of this process's shard
devices, an optional ``torch.distributed`` process group joining the
processes, the mesh's global ``size`` and this process's first global shard
index.  ``make_mesh`` builds a one-process mesh; ``init_multihost`` +
``global_mesh`` one across processes.  ``Mesh.psum`` is the reference's
``lax.psum``: this process's partials summed in shard order, then an
all-reduce over the group.

One departure from the reference: ``make_mesh`` places shards round-robin
on the visible devices, so where there are fewer cards than shards, shards
share a card (on one H100 every shard is on ``cuda:0``).  The reference's
loop closer takes its one-device global BA when the host has fewer chips
than ``cfg.n_devices`` (``asdslam_tpu/loop/loop_closing.py:571``); the
port's always takes the mesh path.

The port computes the step in float64 (f32 in, f32 out), where the
reference computes it in f32.  On a problem whose points are each seen by
one camera, as in the reference's own tests, the depths are unobservable,
H_pp is nearly singular and S_red = H_cc - S cancels to the size of the
damping, so an f32 step is set by rounding: the JAX package's f32 step
differs from its float64 step by 0.10-0.32 in the poses, and the port's
f32 step, summed in another order (another shard count, another device),
by up to 2e-2 from itself (measured on the CPU).  In float64 the step is
the same on every shard count, process topology and device to within f32
rounding of the result, so it is mesh-size-invariant, as the reference's
loop closer means it to be (``asdslam_tpu/loop/loop_closing.py:606-607``),
and it is the JAX package's step run in float64 up to the f32 rounding of
the result (tests/test_torch_parallel.py).

Every per-point, per-camera and per-(point, camera) sum goes through a
gather table built on the host from the layout (``ba.build_pt_obs``) and
sums in the table's order, where the reference scatters with
``.at[...].add``: a CUDA scatter-add sums with atomics in a run-dependent
order, and the port is bitwise equal run to run.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
import torch.distributed as tdist

from asdslam_torch.backend import ba
from asdslam_torch.estimators.linalg import inv3x3
from asdslam_torch.geometry import se3


class Mesh:
    """Shards in global order.  ``devices``: this process's shards'
    devices, in shard order; ``group``: the process group joining the
    processes (None: one process); ``size``: every process's shards;
    ``first``: this process's first global shard index.

    ``reduced_elems`` counts the elements that went through ``psum``: the
    port's stand-in for the all-reduce census of the reference's compiled
    program."""

    def __init__(self, devices, group=None, size=None, first=0):
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = group
        self.size = len(self.devices) if size is None else size
        self.first = first
        self.reduced_elems = 0
        # gloo reduces host tensors: CUDA tensors go through the host, as a
        # fixed rule of the backend, not a retry
        self._via_host = group is not None and tdist.get_backend(group) == "gloo"

    def psum(self, partials: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of every shard's partial, on each of this process's
        shards' devices.  This process's partials are summed in shard
        order on the first shard's device (a fixed order, so the result is
        bitwise reproducible), then all-reduced over the group."""
        dev0 = self.devices[0]
        total = partials[0].to(dev0)
        for p in partials[1:]:
            total = total + p.to(dev0)
        if self.group is not None:
            # a contiguous buffer of its own (the collectives take no strides)
            buf = torch.empty(total.shape, dtype=total.dtype,
                              device="cpu" if self._via_host else dev0).copy_(total)
            tdist.all_reduce(buf, group=self.group)
            total = buf.to(dev0)
        self.reduced_elems += total.numel()
        return [total.to(d) for d in self.devices]

    def gather(self, shards: List[torch.Tensor]) -> torch.Tensor:
        """The shards' rows concatenated in global shard order, on the first
        shard's device: this process's, then, with a group, every
        process's (all-gathered; every process holds as many shards of
        equal size)."""
        dev0 = self.devices[0]
        local = torch.cat([s.to(dev0) for s in shards])
        if self.group is None:
            return local
        src = local.cpu() if self._via_host else local
        parts = [torch.empty_like(src) for _ in range(tdist.get_world_size(self.group))]
        tdist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(dev0)


def _shard_devices(kind: str, first: int, n: int):
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("a CUDA mesh needs a CUDA device")
        return [torch.device("cuda", (first + i) % count) for i in range(n)]
    return [torch.device(kind)] * n


def make_mesh(n_devices: int, device="cuda") -> Mesh:
    """A one-process mesh of ``n_devices`` shards placed round-robin on the
    visible devices of ``device``'s type: with fewer cards than shards the
    shards share them; on the CPU all are "cpu"."""
    return Mesh(_shard_devices(torch.device(device).type, 0, n_devices))


# --------------------------------------------------------------------------- #
# Multi-process runtime (torch.distributed)
# --------------------------------------------------------------------------- #
def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   backend: str = None):
    """Join ``num_processes`` processes into one runtime
    (``torch.distributed.init_process_group`` over TCP at
    ``coordinator_address``, "host:port").

    The backend, unless the caller names one: "nccl" where this host has a
    card for every rank (each rank then uses ``cuda:process_id``), "gloo"
    where ranks share a card or run on the CPU.  A run across hosts passes
    its backend."""
    if backend is None:
        n_cards = torch.cuda.device_count()
        backend = "nccl" if n_cards and n_cards >= num_processes else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = "tcp://" + address
    tdist.init_process_group(backend, init_method=address, world_size=num_processes,
                             rank=process_id)


def global_mesh(local_shards: int = 1, device="cuda") -> Mesh:
    """A mesh over every process of the runtime, ``local_shards`` shards
    each, in rank order; this process's shards go round-robin on its
    visible devices of ``device``'s type from ``cuda:rank * local_shards``
    (modulo the card count)."""
    rank, world = tdist.get_rank(), tdist.get_world_size()
    first = rank * local_shards
    return Mesh(_shard_devices(torch.device(device).type, first, local_shards),
                group=tdist.group.WORLD, size=world * local_shards, first=first)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def shard_to_mesh(mesh: Mesh, x, spec) -> List[torch.Tensor]:
    """This process's shards of ``x`` (identical on every process), each on
    its shard's device: ``spec`` "data" splits the leading axis into
    ``mesh.size`` equal blocks (it must divide), None replicates."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.ascontiguousarray(x))
    if spec is None:
        return [x.to(d) for d in mesh.devices]
    if spec != "data":
        raise ValueError(f"spec must be 'data' or None, not {spec!r}")
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading axis {x.shape[0]} is not divisible by the mesh size "
                         f"{mesh.size}")
    b = x.shape[0] // mesh.size
    return [x[(mesh.first + i) * b:(mesh.first + i + 1) * b].to(d)
            for i, d in enumerate(mesh.devices)]


# --------------------------------------------------------------------------- #
# Data-parallel descriptor inference
# --------------------------------------------------------------------------- #
def dp_descriptor_fn(params, mesh: Mesh):
    """A descriptor function whose patch batch is split over the mesh's
    shards, each shard's slice run through ASDNet on that shard's device,
    the outputs concatenated in shard order (and all-gathered across
    processes).  ``params``: an ``ASDNet`` state dict (``load_weights``) or
    the reference's params dict."""
    from asdslam_torch.models import asdnet

    if "conv" in params:
        params = asdnet.params_from_jax(params)
    nets = {}
    for d in mesh.devices:
        if d not in nets:
            net = asdnet.ASDNet()
            net.load_state_dict(params)
            nets[d] = net.to(d)

    @torch.no_grad()
    def run(patches):
        return mesh.gather([nets[s.device](s) for s in shard_to_mesh(mesh, patches, "data")])

    return run


# --------------------------------------------------------------------------- #
# Distributed BA (point-major-sharded Schur reduction)
# --------------------------------------------------------------------------- #
def layout_point_major(points, cam_idx, pt_idx, uv, inv_sigma2, valid,
                       n_dev: int):
    """Host-side re-layout for ``distributed_ba_step_pm``: block-shard points
    over ``n_dev`` shards and group every observation onto the shard that
    owns its point, with LOCAL point indices.

    Deterministic pure numpy (identical on every process of a multi-process
    run, so each process builds its shards on its own).  Returns
    (points_pad [Pn_pad, 3], cam_idx', pt_idx_local', uv', inv_sigma2',
    valid', Pn_pad) where every per-obs array has length O_pad = n_dev *
    max_per_shard (padded rows have valid=False) and shard d's slice
    [d*Ol:(d+1)*Ol] holds exactly the observations of points
    [d*Pl:(d+1)*Pl], re-indexed to 0..Pl-1."""
    points = np.asarray(points, np.float32)
    cam_idx = np.asarray(cam_idx, np.int32)
    pt_idx = np.asarray(pt_idx, np.int32)
    uv = np.asarray(uv, np.float32)
    inv_sigma2 = np.asarray(inv_sigma2, np.float32)
    valid = np.asarray(valid, bool)
    Pn = len(points)
    Pl = -(-Pn // n_dev)
    Pn_pad = Pl * n_dev
    points_pad = np.zeros((Pn_pad, 3), np.float32)
    points_pad[:Pn] = points

    owner = np.clip(pt_idx, 0, Pn - 1) // Pl
    owner = np.where(valid, owner, 0)          # park invalid rows on shard 0
    counts = np.bincount(owner, minlength=n_dev)
    Ol = max(int(counts.max()), 1)
    O_pad = Ol * n_dev

    def alloc(shape_tail, dtype, fill=0):
        return np.full((O_pad,) + shape_tail, fill, dtype)

    cam_o = alloc((), np.int32)
    pt_o = alloc((), np.int32)
    uv_o = alloc((2,), np.float32)
    s2_o = alloc((), np.float32, 1)
    va_o = alloc((), bool, False)
    order = np.argsort(owner, kind="stable")
    off = np.concatenate([[0], np.cumsum(counts)])
    for d in range(n_dev):
        rows = order[off[d]:off[d + 1]]
        dst = slice(d * Ol, d * Ol + len(rows))
        cam_o[dst] = cam_idx[rows]
        pt_o[dst] = np.where(valid[rows], pt_idx[rows] - d * Pl, 0)
        uv_o[dst] = uv[rows]
        s2_o[dst] = inv_sigma2[rows]
        va_o[dst] = valid[rows]
    return points_pad, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad


class ShardObs(NamedTuple):
    """One shard's observation rows (its slice of ``layout_point_major``'s
    arrays, local point indices) and the gather tables its sums read
    (``ba.build_pt_obs``: row indices, -1 padded)."""

    cam_idx: torch.Tensor   # [Ol] int64
    pt_idx: torch.Tensor    # [Ol] int64, local
    uv: torch.Tensor        # [Ol, 2]
    inv_s2: torch.Tensor    # [Ol]
    valid: torch.Tensor     # [Ol] bool
    pt_obs: torch.Tensor    # [Pl, kp] the rows of each local point
    cam_obs: torch.Tensor   # [n_opt, kc] the rows of each optimized camera
    pair_obs: torch.Tensor  # [Pl * n_opt, kpc] the rows of each (point, camera) pair


def _table(key, mask, n: int) -> np.ndarray:
    width = max(int(np.bincount(key[mask], minlength=1).max()), 1)
    return ba.build_pt_obs(key, mask, n, width).astype(np.int64)


def shard_observations(mesh: Mesh, cam_idx, pt_idx_loc, uv, inv_s2, valid, Pn_pad: int,
                       n_opt: int) -> List[ShardObs]:
    """This process's shards of ``layout_point_major``'s observation arrays,
    with their gather tables built on the host, each on its shard's
    device."""
    cam_idx, pt_idx_loc = _host(cam_idx).astype(np.int64), _host(pt_idx_loc).astype(np.int64)
    uv, inv_s2, valid = _host(uv), _host(inv_s2), _host(valid).astype(bool)
    Ol = len(cam_idx) // mesh.size
    Pl = Pn_pad // mesh.size
    out = []
    for i, d in enumerate(mesh.devices):
        sl = slice((mesh.first + i) * Ol, (mesh.first + i + 1) * Ol)
        cam, pt, va = cam_idx[sl], pt_idx_loc[sl], valid[sl]
        opt = va & (cam < n_opt)
        arrays = (cam, pt, uv[sl], inv_s2[sl], va, _table(pt, va, Pl),
                  _table(cam, opt, n_opt), _table(pt * n_opt + cam, opt, Pl * n_opt))
        out.append(ShardObs(*(torch.as_tensor(np.ascontiguousarray(a)).to(d)
                              for a in arrays)))
    return out


def _seg(x, table):
    """Per-entry sums of ``x``'s rows listed in ``table`` (-1 = none), in
    the table's order."""
    return torch.einsum("nk...,nk->n...", x[table.clamp(min=0)], (table >= 0).to(x.dtype))


# The step's arithmetic (module docstring)
ACC = torch.float64


def make_pm_step(mesh: Mesh, n_opt: int, lam: float = 1e-4):
    """The point-major BA step over a mesh: ``step(poses7, points_pm,
    obs_pm, K)`` with poses7 [C, 7] replicated (one tensor), points_pm and
    obs_pm this process's shards (``shard_to_mesh(mesh, points_pad,
    "data")``, ``shard_observations``).  Returns (new_poses7 on the first
    shard's device, new points shards).  Every landmark block stays on its
    shard; the four camera-side blocks go through ``mesh.psum``."""
    def local_blocks(poses7, points_l, o: ShardObs, K):
        obs_l = ba.Obs(cam_idx=o.cam_idx, pt_idx=o.pt_idx, uv=o.uv,
                       inv_sigma2=o.inv_s2, valid=o.valid)
        r, Jc, Jp, _ = ba._project_residuals(poses7, points_l, obs_l, K)
        w = o.inv_s2 * o.valid.to(r.dtype)
        wc = w * (o.cam_idx < n_opt).to(w.dtype)

        # camera blocks: partial, summed over the mesh, O(C) payload
        Hcc = _seg(torch.einsum("oki,o,okj->oij", Jc, wc, Jc), o.cam_obs)
        gc = _seg(torch.einsum("oki,o,ok->oi", Jc, wc, r), o.cam_obs)

        # landmark blocks: COMPLETE on the shard (every observation of a
        # local point is local by construction)
        Hpp = _seg(torch.einsum("oki,o,okj->oij", Jp, w, Jp), o.pt_obs)
        gp = _seg(torch.einsum("oki,o,ok->oi", Jp, w, r), o.pt_obs)
        eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
        dpp = torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
        Hpp_inv = inv3x3(Hpp + lam * dpp[:, :, None] * eye3 + 1e-8 * eye3)

        # Schur reduction: the per-point per-camera aggregates are local;
        # the contraction over LOCAL points is this shard's part of S, the
        # only quadratic-in-C payload.  W is zero on rows of fixed cameras.
        W = torch.einsum("oki,o,okj->oij", Jc, wc, Jp)               # [O_l, 6, 3]
        Y = torch.einsum("oij,ojk->oik", W, Hpp_inv[o.pt_idx])       # [O_l, 6, 3]
        Pl = points_l.shape[0]
        camA = _seg(Y, o.pair_obs).reshape(Pl, n_opt, 6, 3)
        camB = _seg(W, o.pair_obs).reshape(Pl, n_opt, 6, 3)
        S = torch.einsum("paij,pbkj->abik", camA, camB)              # [C, C, 6, 6]
        gp_red = torch.einsum("paij,pj->ai", camA, gp)               # [C, 6]
        return (Hcc, gc, S, gp_red), (W, Hpp_inv, gp)

    def solve(Hcc, gc, S, gp_red):
        dev = Hcc.device
        dcc = torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-6)
        Hcc_d = Hcc + lam * dcc[:, :, None] * torch.eye(6, dtype=ACC, device=dev)
        S_red = (torch.block_diag(*Hcc_d.unbind(0))
                 - S.permute(0, 2, 1, 3).reshape(n_opt * 6, n_opt * 6)
                 + 1e-8 * torch.eye(n_opt * 6, dtype=ACC, device=dev))
        rhs = (gc - gp_red).reshape(-1, 1)
        # the reference's jnp.linalg.solve: no error check (a singular
        # system gives non-finite steps), so no wait on the device
        return -torch.linalg.solve_ex(S_red, rhs)[0].reshape(n_opt, 6)

    def step(poses7, points_pm, obs_pm, K):
        dtype = points_pm[0].dtype
        points_pm = [p.to(ACC) for p in points_pm]
        obs_pm = [o._replace(uv=o.uv.to(ACC), inv_s2=o.inv_s2.to(ACC)) for o in obs_pm]
        parts, local = [], []
        for pts, o in zip(points_pm, obs_pm):
            dev = pts.device
            reduce_me, keep = local_blocks(poses7.to(dev, ACC), pts, o, K.to(dev, ACC))
            parts.append(reduce_me)
            local.append(keep)
        Hcc, gc, S, gp_red = (mesh.psum([p[j] for p in parts]) for j in range(4))

        dcs, new_points = {}, []
        for i, (pts, o, (W, Hpp_inv, gp)) in enumerate(zip(points_pm, obs_pm, local)):
            dev = pts.device
            if dev not in dcs:  # replicated solve, once per device
                dcs[dev] = solve(Hcc[i], gc[i], S[i], gp_red[i])
            dc = dcs[dev]
            # landmark back-substitution: fully local
            safe_cam = torch.clamp(o.cam_idx, max=n_opt - 1)
            WT_dc = _seg(torch.einsum("oij,oi->oj", W, dc[safe_cam]), o.pt_obs)
            dp = torch.einsum("pij,pj->pi", Hpp_inv, gp + WT_dc)
            new_points.append((pts - dp).to(dtype))

        dev0 = mesh.devices[0]
        poses7 = poses7.to(dev0)
        new_opt = se3.pose_retract(poses7[:n_opt].to(ACC), dcs[dev0]).to(poses7.dtype)
        return torch.cat([new_opt, poses7[n_opt:]], dim=0), new_points

    return step


def distributed_ba_step_pm(mesh: Mesh, poses7, points_pm, obs_pm, K, n_opt: int,
                           lam: float = 1e-4):
    """One Gauss-Newton BA step over point-major shards (see
    ``layout_point_major``, ``shard_observations``).  All landmark math
    stays on its shard; the reductions are the O(C^2) camera blocks only.
    Returns (new_poses7 replicated, new points shards).  The reference
    passes the five observation arrays; the port passes each shard's rows
    with their gather tables."""
    return make_pm_step(mesh, n_opt, lam)(poses7, points_pm, obs_pm, torch.as_tensor(K))


def distributed_ba_step(mesh: Mesh, poses7, points, obs: ba.Obs, pt_obs_unused, K,
                        n_opt: int, lam: float = 1e-4):
    """One Gauss-Newton step of BA distributed over a one-process mesh:
    the point-major re-layout and its tables on the host, then
    ``distributed_ba_step_pm``.  Returns (new_poses7, new_points) with the
    original point count, on the first shard's device."""
    points = _host(points)
    Pn = points.shape[0]
    (points_pm, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad) = layout_point_major(
        points, _host(obs.cam_idx), _host(obs.pt_idx), _host(obs.uv),
        _host(obs.inv_sigma2), _host(obs.valid), mesh.size)
    obs_pm = shard_observations(mesh, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad, n_opt)
    new_poses, new_points = distributed_ba_step_pm(
        mesh, torch.as_tensor(_host(poses7)), shard_to_mesh(mesh, points_pm, "data"), obs_pm,
        K, n_opt, lam)
    return new_poses, mesh.gather(new_points)[:Pn]
