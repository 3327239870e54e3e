"""Fused masked nearest-neighbour search: the hand-written CUDA kernel
(``csrc/masked_nn.cu``), its wrapper, and its plain PyTorch version.

Port of ``asdslam_tpu/ops/pallas_match.py::masked_nn``.  For each row of A:
the squared L2 distance to every column of B (bf16 dot, f32 norms), gated by
a per-row window, validity on both sides and a level-difference window, with
gated pairs at BIG = 1e30; returns (idx, best, second) per row, idx being the
first-occurrence argmin and second the min over all other columns.

``masked_nn`` launches the kernel for CUDA tensors and counts the launch in
``masked_nn.launches``; for CPU tensors it runs ``masked_nn_plain``.  It never
falls back from the kernel: a tensor it cannot take, or a failed launch,
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from asdslam_torch import kernels

BIG = 1e30
DESC_DIM = 128  # the kernel's compiled descriptor width

_c_ptr = ctypes.c_void_p
_ARGTYPES = ([_c_ptr] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
             + [_c_ptr] * 4)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    fn = kernels.load("masked_nn").masked_nn_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _defaults(desc_a, desc_b, uv_a, uv_b, rad2, levels_a, levels_b):
    """Fill the optional inputs the reference allows to be None: no window
    (rad2 = BIG), positions and levels zero."""
    n, m, dev = desc_a.shape[0], desc_b.shape[0], desc_a.device
    if uv_a is None:
        uv_a = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    if uv_b is None:
        uv_b = torch.zeros((m, 2), dtype=torch.float32, device=dev)
    if rad2 is None:
        rad2 = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    if levels_a is None:
        levels_a = torch.zeros((n,), dtype=torch.int32, device=dev)
    if levels_b is None:
        levels_b = torch.zeros((m,), dtype=torch.int32, device=dev)
    return uv_a, uv_b, rad2, levels_a, levels_b


def masked_nn_plain(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2,
                    levels_a, levels_b, level_window=(-1e9, 1e9)):
    """The same function as the kernel, on the full [N, M] distance matrix
    (the reference's distance-matrix path, match.py:235-243, with BIG in
    place of +inf)."""
    dmin, dmax = float(level_window[0]), float(level_window[1])
    a2 = torch.sum(desc_a * desc_a, dim=1)
    b2 = torch.sum(desc_b * desc_b, dim=1)
    ab = desc_a.to(torch.bfloat16).to(torch.float32) @ desc_b.to(torch.bfloat16).to(torch.float32).T
    dist = torch.clamp(a2[:, None] + b2[None, :] - 2.0 * ab, min=0.0)
    dx = uv_a[:, None, 0] - uv_b[None, :, 0]
    dy = uv_a[:, None, 1] - uv_b[None, :, 1]
    ld = (levels_b[None, :] - levels_a[:, None]).to(torch.float32)
    ok = ((dx * dx + dy * dy) <= rad2[:, None]) & valid_a[:, None] & valid_b[None, :]
    ok = ok & (ld >= dmin) & (ld <= dmax)
    dist = torch.where(ok, dist, BIG)
    idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, idx[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    second = torch.where(cols[None, :] == idx[:, None], BIG, dist).amin(dim=1)
    return idx.to(torch.int32), best, second


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"masked_nn: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"masked_nn: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"masked_nn: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"masked_nn: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"masked_nn: {name} is not contiguous")


def masked_nn(desc_a, desc_b, valid_a, valid_b, uv_a=None, uv_b=None, rad2=None,
              levels_a=None, levels_b=None, level_window=(-1e9, 1e9)):
    """Fused masked NN search.

    desc_a [N, 128] / desc_b [M, 128] float32; valid_a [N] / valid_b [M]
    bool; uv_a [N, 2] / uv_b [M, 2] float32; rad2 [N] float32, the SQUARED
    window radius per row (None: no window); levels_a [N] / levels_b [M]
    int32; level_window bounds levels_b[j] - levels_a[i], inclusive.
    Returns (idx [N] int32, best [N] f32, second [N] f32); masked rows have
    best == second == BIG.
    """
    uv_a, uv_b, rad2, levels_a, levels_b = _defaults(
        desc_a, desc_b, uv_a, uv_b, rad2, levels_a, levels_b)
    args = (desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, levels_a, levels_b)
    if desc_a.device.type == "cpu":
        return masked_nn_plain(*args, level_window)
    if desc_a.device.type != "cuda":
        raise ValueError(f"masked_nn: no kernel for device {desc_a.device}")

    n, d = desc_a.shape
    m = desc_b.shape[0]
    dev = desc_a.device
    for name, t, dtype, shape in (
            ("desc_a", desc_a, torch.float32, (n, DESC_DIM)),
            ("desc_b", desc_b, torch.float32, (m, DESC_DIM)),
            ("valid_a", valid_a, torch.bool, (n,)),
            ("valid_b", valid_b, torch.bool, (m,)),
            ("uv_a", uv_a, torch.float32, (n, 2)),
            ("uv_b", uv_b, torch.float32, (m, 2)),
            ("rad2", rad2, torch.float32, (n,)),
            ("levels_a", levels_a, torch.int32, (n,)),
            ("levels_b", levels_b, torch.int32, (m,))):
        _check(name, t, dtype, shape, dev)
    if n == 0 or m == 0:
        raise ValueError(f"masked_nn: empty input (N={n}, M={m})")

    a2 = torch.sum(desc_a * desc_a, dim=1)
    b2 = torch.sum(desc_b * desc_b, dim=1)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    best = torch.empty(n, dtype=torch.float32, device=dev)
    second = torch.empty(n, dtype=torch.float32, device=dev)

    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(desc_a.data_ptr(), desc_b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
                uv_a.data_ptr(), uv_b.data_ptr(), rad2.data_ptr(),
                valid_a.data_ptr(), valid_b.data_ptr(),
                levels_a.data_ptr(), levels_b.data_ptr(),
                n, m, d, float(level_window[0]), float(level_window[1]),
                idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"masked_nn kernel launch failed: cudaError_t {rc}")
    masked_nn.launches += 1
    return idx, best, second


masked_nn.launches = 0
