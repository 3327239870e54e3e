"""Motion-only BA's Levenberg-Marquardt iteration and chi2 gate: the
hand-written CUDA kernels (``csrc/pose_lm.cu``), their wrapper, and their
plain PyTorch versions.

``backend/ba.py::pose_only_optimize`` keeps the solver's schedule (rounds,
iterations, Huber in every round but the last, the damping's reset a round)
and calls two operators:

- ``pose_lm_step(pose, lam, cost, points, uv, inv_sigma2, inliers, K,
  use_huber) -> (pose, lam, cost)``: one LM iteration, accept or reject
  and the damping update included (``step_plain``);
- ``pose_lm_gate(pose, points, uv, inv_sigma2, valid, K, chi2_th, gate) ->
  (inliers, cost)``: the inliers of the next round, ``valid & chi2 <=
  chi2_th & z > 0`` (with ``gate`` off, ``valid``), and the pose's Huber
  cost over them, the next round's starting cost (``gate_plain``).

For CUDA tensors each launches its kernel and counts the launch in
``pose_lm.launches``; a launch captured in a CUDA graph (``utils/graphs.py``)
is counted at each replay.  For CPU tensors each runs its plain version.
Neither falls back from the kernel: a tensor it cannot take (another dtype
than float32, or bool for the masks; another shape or device; not
contiguous), or a failed launch, raises.

A leading batch axis on every input (``pose`` [B, 7], ``lam`` and ``cost``
[B], ``points`` [B, N, 3], ``K`` [B, 3, 3], ...) is B independent problems:
one launch on CUDA, counted once, each problem in a block of its own; on the
CPU the plain version once per problem.  Under ``torch.func.vmap`` the
wrappers call the custom operators ``torch.ops.asdslam.pose_lm_step`` and
``pose_lm_gate``, whose vmap rules make the vmapped axis that batch, so the
multi-sequence tracking step reaches the batched launch.  Each problem's
results are the bits of its own call.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from asdslam_torch import kernels
from asdslam_torch.estimators.linalg import chol_solve_small
from asdslam_torch.geometry import se3
from asdslam_torch.geometry.reprojection import CHI2_MONO, Obs, huber_weight, project_residuals
from asdslam_torch.utils import batching
from asdslam_torch.utils import graphs

launches = 0  # kernel launches of both operators (a captured one at each replay)
_lock = threading.Lock()  # guards launches

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_STEP_NAMES = ("pose", "lam", "cost", "points", "uv", "inv_sigma2", "inliers", "K")
_STEP_DTYPES = (torch.float32,) * 6 + (torch.bool, torch.float32)
_STEP_SHAPES = ((7,), (), (), ("n", 3), ("n", 2), ("n",), ("n",), (3, 3))
_GATE_NAMES = ("pose", "points", "uv", "inv_sigma2", "valid", "K")
_GATE_DTYPES = (torch.float32,) * 4 + (torch.bool, torch.float32)
_GATE_SHAPES = ((7,), ("n", 3), ("n", 2), ("n",), ("n",), (3, 3))


# --------------------------------------------------------------------------- #
# The plain versions
# --------------------------------------------------------------------------- #
def _obs(points, uv, inv_sigma2, mask):
    """One camera's observation table over every point."""
    n, dev = points.shape[0], points.device
    return Obs(cam_idx=torch.zeros(n, dtype=torch.int64, device=dev),
               pt_idx=torch.arange(n, device=dev), uv=uv, inv_sigma2=inv_sigma2, valid=mask)


def _chi2(pose, points, obs, K):
    """(chi2 [N], depth z [N]) of every observation at ``pose``."""
    r, _, _, z = project_residuals(pose[None], points, obs, K)
    return torch.sum(r * r, dim=1) * obs.inv_sigma2, z


def _cost(pose, points, obs, K, inliers):
    """The Huber cost rho(chi2) of ``pose`` summed over ``inliers``."""
    delta2 = CHI2_MONO
    chi2, _ = _chi2(pose, points, obs, K)
    c = torch.where(chi2 <= delta2, chi2,
                    2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
    return batching.sum(torch.where(inliers, c, torch.zeros_like(c)))


def step_plain(pose, lam, cost, points, uv, inv_sigma2, inliers, K, use_huber: bool):
    """One LM iteration of one problem, in plain PyTorch: the normal
    equations over the inliers (Huber-weighted when ``use_huber``), the
    damped solve, the candidate exp(-dx) * pose and its cost; accepted
    iff that cost is lower.  Returns (pose, lam, cost)."""
    obs = _obs(points, uv, inv_sigma2, inliers)
    delta2 = CHI2_MONO
    eye6 = torch.eye(6, dtype=pose.dtype, device=points.device)
    r, Jc, _, _ = project_residuals(pose[None], points, obs, K)
    chi2 = torch.sum(r * r, dim=1) * inv_sigma2
    w_h = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = inv_sigma2 * w_h * inliers.to(r.dtype)
    H = batching.einsum("oki,o,okj->ij", Jc, w, Jc)
    g = batching.einsum("oki,o,ok->i", Jc, w, r)
    Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
    cand = se3.pose_retract(pose, -chol_solve_small(Hd, g))
    new_cost = _cost(cand, points, obs, K, inliers)
    accept = new_cost < cost
    return (torch.where(accept, cand, pose),
            torch.where(accept, torch.clamp(lam * 0.33, min=1e-9),
                        torch.clamp(lam * 4.0, max=1e6)),
            torch.where(accept, new_cost, cost))


def gate_plain(pose, points, uv, inv_sigma2, valid, K, chi2_th: float, gate: bool = True):
    """The chi2 gate of one problem, in plain PyTorch: (inliers, the Huber
    cost of ``pose`` over them); with ``gate`` off the inliers are
    ``valid``."""
    obs = _obs(points, uv, inv_sigma2, valid)
    if gate:
        chi2, z = _chi2(pose, points, obs, K)
        inliers = valid & (chi2 <= chi2_th) & (z > 0)
    else:
        inliers = valid.clone()
    return inliers, _cost(pose, points, obs, K, inliers)


def _per_problem(fn, tensors, consts):
    """``fn`` on one problem, or once per problem of a batch (each on a
    fresh copy of its inputs, allocated as a single call's own), stacked."""
    if tensors[0].ndim == 1:
        return fn(*tensors, *consts)
    outs = [fn(*(t[b].clone() for t in tensors), *consts) for b in range(tensors[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


# --------------------------------------------------------------------------- #
# The kernels
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' library, built and loaded at first use, with its entry
    points typed."""
    lib = kernels.load("pose_lm")
    lib.pose_lm_step_launch.argtypes = [_PTR] * 8 + [_INT] * 3 + [_PTR] * 4
    lib.pose_lm_step_launch.restype = _INT
    lib.pose_lm_gate_launch.argtypes = ([_PTR] * 6 + [_INT, _INT, ctypes.c_float, _INT]
                                        + [_PTR] * 3)
    lib.pose_lm_gate_launch.restype = _INT
    return lib


def _check(op, name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{op}: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} is not contiguous")


def _validate(op, names, tensors, dtypes, shapes):
    """Check every input against one problem's shapes ([N] from ``points``)
    or a batch of them; returns (leading batch shape, N, batch size)."""
    pose, points = tensors[0], tensors[names.index("points")]
    if not isinstance(pose, torch.Tensor) or pose.ndim not in (1, 2):
        raise ValueError(f"{op}: pose must be a [7] or [B, 7] tensor")
    lead = tuple(pose.shape[:-1])
    if not isinstance(points, torch.Tensor) or points.ndim != len(lead) + 2:
        raise ValueError(f"{op}: points must be [N, 3], or [B, N, 3] with a [B, 7] pose")
    n = points.shape[-2]
    for name, t, dtype, shape in zip(names, tensors, dtypes, shapes):
        _check(op, name, t, dtype, lead + tuple(n if s == "n" else s for s in shape),
               pose.device)
    batch = lead[0] if lead else 1
    if batch == 0:
        raise ValueError(f"{op}: empty batch")
    return lead, n, batch


def _launch(op, entry, tensors, consts, outs):
    """Launch ``entry`` on the current stream of the inputs' device."""
    dev = tensors[0].device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = ([t.data_ptr() for t in tensors] + list(consts) + [t.data_ptr() for t in outs]
            + [stream])
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            rc = entry(*args)
    else:
        rc = entry(*args)
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError_t {rc}")
    graphs.host_effect(_count)


def _count():
    """One launch in ``pose_lm.launches``; inside a graph capture, at each
    replay instead (``graphs.host_effect``)."""
    global launches
    with _lock:
        launches += 1


def _device(op, tensors):
    dev = tensors[0].device if isinstance(tensors[0], torch.Tensor) else None
    if dev is None or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {dev}")
    return dev.type


def _run_step(tensors, use_huber):
    """The LM iteration on real tensors (one problem or a batch): the plain
    version on the CPU, the kernel on CUDA."""
    if _device("pose_lm_step", tensors) == "cpu":
        return _per_problem(step_plain, tensors, (use_huber,))
    lead, n, batch = _validate("pose_lm_step", _STEP_NAMES, tensors, _STEP_DTYPES,
                               _STEP_SHAPES)
    dev = tensors[0].device
    outs = (torch.empty(lead + (7,), dtype=torch.float32, device=dev),
            torch.empty(lead, dtype=torch.float32, device=dev),
            torch.empty(lead, dtype=torch.float32, device=dev))
    _launch("pose_lm_step", _lib().pose_lm_step_launch, tensors, (n, batch, int(use_huber)),
            outs)
    return outs


def _run_gate(tensors, chi2_th, gate):
    """The gate on real tensors (one problem or a batch): the plain version
    on the CPU, the kernel on CUDA."""
    if _device("pose_lm_gate", tensors) == "cpu":
        return _per_problem(gate_plain, tensors, (chi2_th, gate))
    lead, n, batch = _validate("pose_lm_gate", _GATE_NAMES, tensors, _GATE_DTYPES,
                               _GATE_SHAPES)
    dev = tensors[0].device
    outs = (torch.empty(lead + (n,), dtype=torch.bool, device=dev),
            torch.empty(lead, dtype=torch.float32, device=dev))
    _launch("pose_lm_gate", _lib().pose_lm_gate_launch, tensors,
            (n, batch, float(chi2_th), int(gate)), outs)
    return outs


def pose_lm_step(pose, lam, cost, points, uv, inv_sigma2, inliers, K, use_huber: bool):
    """One LM iteration of motion-only BA (module docstring): pose [7], lam
    and cost [] float32, points [N, 3], uv [N, 2], inv_sigma2 [N] float32,
    inliers [N] bool, K [3, 3]; every input may carry a leading batch axis.
    Returns (pose, lam, cost)."""
    tensors = (pose, lam, cost, points, uv, inv_sigma2, inliers, K)
    if graphs._transformed(tensors):
        # under torch.func.vmap: the operator's vmap rule batches the call
        return torch.ops.asdslam.pose_lm_step(*tensors, bool(use_huber))
    return _run_step(tensors, bool(use_huber))


def pose_lm_gate(pose, points, uv, inv_sigma2, valid, K, chi2_th: float, gate: bool = True):
    """The chi2 gate between rounds of motion-only BA (module docstring):
    pose [7], points [N, 3], uv [N, 2], inv_sigma2 [N] float32, valid [N]
    bool, K [3, 3]; every input may carry a leading batch axis.  Returns
    (inliers [N] bool, cost [])."""
    tensors = (pose, points, uv, inv_sigma2, valid, K)
    if graphs._transformed(tensors):
        return torch.ops.asdslam.pose_lm_gate(*tensors, float(chi2_th), bool(gate))
    return _run_gate(tensors, float(chi2_th), bool(gate))


def _step_op(pose: torch.Tensor, lam: torch.Tensor, cost: torch.Tensor, points: torch.Tensor,
             uv: torch.Tensor, inv_sigma2: torch.Tensor, inliers: torch.Tensor, K: torch.Tensor,
             use_huber: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _run_step((pose, lam, cost, points, uv, inv_sigma2, inliers, K), use_huber)


def _gate_op(pose: torch.Tensor, points: torch.Tensor, uv: torch.Tensor,
             inv_sigma2: torch.Tensor, valid: torch.Tensor, K: torch.Tensor, chi2_th: float,
             gate: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return _run_gate((pose, points, uv, inv_sigma2, valid, K), chi2_th, gate)


def _batch_first(info, in_dims, tensors):
    """The vmapped axis first on every input (an unbatched one repeated)."""
    return [(t.movedim(dim, 0) if dim is not None
             else t.expand((info.batch_size,) + t.shape)).contiguous()
            for t, dim in zip(tensors, in_dims)]


def _step_vmap(info, in_dims, *args):
    tensors = _batch_first(info, in_dims[:8], args[:8])
    return torch.ops.asdslam.pose_lm_step(*tensors, args[8]), (0, 0, 0)


def _gate_vmap(info, in_dims, *args):
    tensors = _batch_first(info, in_dims[:6], args[:6])
    return torch.ops.asdslam.pose_lm_gate(*tensors, *args[6:]), (0, 0)


if not hasattr(torch.ops.asdslam, "pose_lm_step"):  # once per process
    torch.library.custom_op("asdslam::pose_lm_step", mutates_args=())(_step_op)
    torch.library.register_vmap("asdslam::pose_lm_step", _step_vmap)
    torch.library.custom_op("asdslam::pose_lm_gate", mutates_args=())(_gate_op)
    torch.library.register_vmap("asdslam::pose_lm_gate", _gate_vmap)
