"""Fused masked nearest-neighbour search: the hand-written CUDA kernel
(``csrc/masked_nn.cu``), its wrapper, its plain PyTorch version, and the
plain version of the kernel's preparation (cell order and tile summaries).

Port of ``asdslam_tpu/ops/pallas_match.py::masked_nn``.  For each row of A:
the squared L2 distance to every column of B (bf16 dot, f32 norms), gated by
a per-row window, validity on both sides and a level-difference window, with
gated pairs at BIG = 1e30; returns (idx, best, second) per row, idx being the
first-occurrence argmin and second the min over all other columns.

The kernel orders rows and columns by the 32-px cell of their position,
summarises every 64-entry tile (a box, a level range, a count of entries
that can pass the gate) and skips the tile pairs whose summaries cannot
meet; ``prepare_plain`` and ``live_tiles`` compute the same in plain PyTorch
so the culling can be checked without a card.

``masked_nn`` launches the kernel for CUDA tensors and counts the call in
``masked_nn.launches``; for CPU tensors it runs ``masked_nn_plain``.  It never
falls back from the kernel: a tensor it cannot take, or a failed launch,
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from asdslam_torch import kernels

BIG = 1e30
DESC_DIM = 128  # the kernel's compiled descriptor width
TILE = 64       # entries per row tile and per column tile
CELL = 32.0     # cell size of the ordering, px
CELLS = 64      # cells per axis; positions beyond clamp to the edge cells
INERT = CELLS * CELLS  # the sort key of entries that cannot pass the gate

_c_ptr = ctypes.c_void_p
_ARGTYPES = ([_c_ptr] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [_c_ptr] * 5)
# the scratch fields, in the order of the C source's layout
_FIELDS = ("perm_a", "perm_b", "a16", "b16", "ainfo", "binfo", "arad", "aidx", "bidx",
           "rsum", "csum", "pbest", "pidx", "psec", "done")


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library, built and loaded at first use, with its entry
    points typed."""
    lib = kernels.load("masked_nn")
    lib.masked_nn_launch.argtypes = _ARGTYPES
    lib.masked_nn_launch.restype = ctypes.c_int
    lib.masked_nn_scratch_layout.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_longlong),
                                             ctypes.POINTER(ctypes.c_int)]
    lib.masked_nn_scratch_layout.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _layout(n, m):
    """(scratch bytes, {field: byte offset}, column splits) for N rows and
    M columns, as the C source lays the scratch out."""
    offsets = (ctypes.c_longlong * len(_FIELDS))()
    splits = ctypes.c_int()
    nbytes = _lib().masked_nn_scratch_layout(n, m, offsets, ctypes.byref(splits))
    return nbytes, dict(zip(_FIELDS, offsets)), splits.value


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


def gate_plain(valid_a, valid_b, uv_a, uv_b, rad2, levels_a, levels_b,
               level_window=(-1e9, 1e9)):
    """[N, M] bool: the pairs that pass the window, validity and level
    gates (each f32 operation rounded on its own, as in the kernel)."""
    dmin, dmax = float(level_window[0]), float(level_window[1])
    dx = uv_a[:, None, 0] - uv_b[None, :, 0]
    dy = uv_a[:, None, 1] - uv_b[None, :, 1]
    ld = (levels_b[None, :] - levels_a[:, None]).to(torch.float32)
    ok = ((dx * dx + dy * dy) <= rad2[:, None]) & valid_a[:, None] & valid_b[None, :]
    return ok & (ld >= dmin) & (ld <= dmax)


def masked_nn_plain(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2,
                    levels_a, levels_b, level_window=(-1e9, 1e9)):
    """The same function as the kernel, on the full [N, M] distance matrix
    (the reference's distance-matrix path, match.py:235-243, with BIG in
    place of +inf)."""
    a2 = torch.sum(desc_a * desc_a, dim=1)
    b2 = torch.sum(desc_b * desc_b, dim=1)
    ab = desc_a.to(torch.bfloat16).to(torch.float32) @ desc_b.to(torch.bfloat16).to(torch.float32).T
    dist = torch.clamp(a2[:, None] + b2[None, :] - 2.0 * ab, min=0.0)
    ok = gate_plain(valid_a, valid_b, uv_a, uv_b, rad2, levels_a, levels_b, level_window)
    dist = torch.where(ok, dist, BIG)
    idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, idx[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    second = torch.where(cols[None, :] == idx[:, None], BIG, dist).amin(dim=1)
    return idx.to(torch.int32), best, second


# --------------------------------------------------------------------------- #
# The kernel's preparation, in plain PyTorch
# --------------------------------------------------------------------------- #
class TileSummary(NamedTuple):
    """Per 64-entry tile: the box [x_lo, x_hi, y_lo, y_hi] of its entries
    that can pass the gate (rows: widened by the window), their level range,
    and their count (0: the tile meets nothing)."""

    box: torch.Tensor    # [T, 4] float32
    lmin: torch.Tensor   # [T] int32
    lmax: torch.Tensor   # [T] int32
    count: torch.Tensor  # [T] int32


class Prepared(NamedTuple):
    perm_a: torch.Tensor  # [N rounded up to 64] int64, sorted position -> row, -1 past N
    perm_b: torch.Tensor  # [M rounded up to 64] int64
    rows: TileSummary
    cols: TileSummary


def can_pass(valid, uv, rad2=None):
    """Entries that can pass the exact gate with some partner: valid, with a
    position (and, for rows, a radius) that is not NaN."""
    ok = valid & ~torch.isnan(uv).any(dim=1)
    return ok if rad2 is None else ok & ~torch.isnan(rad2)


def _spread6(v):
    out = torch.zeros_like(v)
    for b in range(6):
        out |= ((v >> b) & 1) << (2 * b)
    return out


def sort_keys(valid, uv, rad2=None):
    """The Morton code of each entry's 32-px cell (cells past the 64th
    clamp to the edge), INERT for entries that cannot pass the gate."""
    cell = torch.clamp(torch.floor(uv * (1.0 / CELL)), 0.0, CELLS - 1.0)
    cell = torch.nan_to_num(cell).to(torch.int64)
    key = _spread6(cell[:, 0]) | (_spread6(cell[:, 1]) << 1)
    return torch.where(can_pass(valid, uv, rad2), key, INERT)


def row_boxes(uv, rad2):
    """[N, 4] box per row holding every column its f32 gate can admit:
    uv +- (sqrt(rad2) + 1 px + 1e-6 of the magnitudes); the whole plane
    where the position or radius is not finite."""
    r = torch.sqrt(torch.clamp(rad2, min=0.0))
    x, y = uv[:, 0], uv[:, 1]
    mx = 1.0 + 1e-6 * (x.abs() + r)
    my = 1.0 + 1e-6 * (y.abs() + r)
    box = torch.stack([(x - r) - mx, (x + r) + mx, (y - r) - my, (y + r) + my], dim=1)
    finite = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(r)
    whole = torch.tensor([-float("inf"), float("inf"), -float("inf"), float("inf")],
                         device=uv.device)
    return torch.where(finite[:, None], box, whole)


def _summaries(perm, box, levels, passes):
    """TileSummary of the entries in sorted order ``perm`` (-1: padding)."""
    t = perm.shape[0] // TILE
    e = perm.clamp(min=0)
    inside = (passes[e] & (perm >= 0)).reshape(t, TILE)
    inf = float("inf")
    b = box[e].reshape(t, TILE, 4)
    lo = torch.where(inside[..., None], b[..., 0::2], inf).amin(dim=1)
    hi = torch.where(inside[..., None], b[..., 1::2], -inf).amax(dim=1)
    lv = levels[e].reshape(t, TILE)
    i32 = torch.iinfo(torch.int32)
    return TileSummary(
        box=torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=1),
        lmin=torch.where(inside, lv, i32.max).amin(dim=1).to(torch.int32),
        lmax=torch.where(inside, lv, i32.min).amax(dim=1).to(torch.int32),
        count=inside.sum(dim=1).to(torch.int32))


def _padded_order(keys):
    n = keys.shape[0]
    perm = torch.sort(keys, stable=True).indices
    pad = -n % TILE
    return torch.cat([perm, perm.new_full((pad,), -1)])


def prepare_plain(valid_a, valid_b, uv_a, uv_b, rad2, levels_a, levels_b):
    """The kernel's ordering and tile summaries (the kernel's order inside a
    cell may differ; nothing depends on it)."""
    pass_a, pass_b = can_pass(valid_a, uv_a, rad2), can_pass(valid_b, uv_b)
    perm_a = _padded_order(sort_keys(valid_a, uv_a, rad2))
    perm_b = _padded_order(sort_keys(valid_b, uv_b))
    cols_box = torch.stack([uv_b[:, 0], uv_b[:, 0], uv_b[:, 1], uv_b[:, 1]], dim=1)
    return Prepared(perm_a, perm_b,
                    _summaries(perm_a, row_boxes(uv_a, rad2), levels_a, pass_a),
                    _summaries(perm_b, cols_box, levels_b, pass_b))


def live_tiles(rows: TileSummary, cols: TileSummary, level_window=(-1e9, 1e9)):
    """[row tiles, column tiles] bool: the tile pairs the kernel visits.
    A pair is skipped only when the boxes miss, the level ranges cannot meet
    within ``level_window``, or either side has nothing that can pass."""
    r, c = rows.box[:, None, :], cols.box[None, :, :]
    meet = ((r[..., 0] <= c[..., 1]) & (c[..., 0] <= r[..., 1])
            & (r[..., 2] <= c[..., 3]) & (c[..., 2] <= r[..., 3]))
    hi = (cols.lmax[None, :] - rows.lmin[:, None]).to(torch.float32)
    lo = (cols.lmin[None, :] - rows.lmax[:, None]).to(torch.float32)
    meet &= (hi >= float(level_window[0])) & (lo <= float(level_window[1]))
    return meet & (rows.count[:, None] > 0) & (cols.count[None, :] > 0)


def culled_gated_pairs(prep: Prepared, gated, level_window=(-1e9, 1e9)):
    """(pairs that pass the gate ``gated`` [N, M] yet lie in a tile pair
    that ``prep``'s summaries cull -- 0 when the culling is conservative --,
    the [row tiles, column tiles] live matrix)."""
    live = live_tiles(prep.rows, prep.cols, level_window)
    tiles = []
    for perm, size in ((prep.perm_a, gated.shape[0]), (prep.perm_b, gated.shape[1])):
        t = torch.empty(size, dtype=torch.int64, device=perm.device)
        pos = torch.nonzero(perm >= 0)[:, 0]
        t[perm[pos]] = pos // TILE
        tiles.append(t)
    i, j = torch.nonzero(gated, as_tuple=True)
    return int((~live[tiles[0][i], tiles[1][j]]).sum()), live


# --------------------------------------------------------------------------- #
# The kernel
# --------------------------------------------------------------------------- #
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


_NAMES = ("desc_a", "desc_b", "valid_a", "valid_b", "uv_a", "uv_b", "rad2", "levels_a",
          "levels_b")
_DTYPES = (torch.float32, torch.float32, torch.bool, torch.bool, torch.float32,
           torch.float32, torch.float32, torch.int32, torch.int32)
_scratch = {}  # (device index, stream, N, M) -> scratch buffer, reused in stream order


def _launch(args, level_window, scratch=None):
    """Check the nine inputs, launch the kernel; returns ((idx, best,
    second), scratch buffer).  Without ``scratch`` the call reuses one
    buffer per device, stream and shape (calls on one stream run in order)."""
    desc_a, desc_b = args[0], args[1]
    n, d = desc_a.shape
    m = desc_b.shape[0]
    dev = desc_a.device
    index = dev.index
    shapes = ((n, DESC_DIM), (m, DESC_DIM), (n,), (m,), (n, 2), (m, 2), (n,), (n,), (m,))
    for name, t, dtype, shape in zip(_NAMES, args, _DTYPES, shapes):
        # the common case in one cheap test; the full check names the fault
        if not (isinstance(t, torch.Tensor) and t.dtype is dtype and t.shape == shape
                and t.get_device() == index and t.is_contiguous()):
            _check(name, t, dtype, shape, dev)
    if n == 0 or m == 0:
        raise ValueError(f"masked_nn: empty input (N={n}, M={m})")

    lib = _lib()
    # the raw handle of the current stream (torch.cuda.current_stream(dev)
    # .cuda_stream, without building a Stream object)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if scratch is None:
        key = (index, stream, n, m)
        scratch = _scratch.get(key)
        if scratch is None:
            if len(_scratch) > 16:
                _scratch.clear()
            scratch = _scratch[key] = torch.empty(_layout(n, m)[0], dtype=torch.uint8,
                                                  device=dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    idx, best, second = out[0].view(torch.int32), out[1], out[2]
    base = out.data_ptr()
    ptrs = [t.data_ptr() for t in args]
    lw = (float(level_window[0]), float(level_window[1]))
    if index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            rc = lib.masked_nn_launch(*ptrs, n, m, d, *lw, scratch.data_ptr(), base,
                                      base + 4 * n, base + 8 * n, stream)
    else:
        rc = lib.masked_nn_launch(*ptrs, n, m, d, *lw, scratch.data_ptr(), base,
                                  base + 4 * n, base + 8 * n, stream)
    if rc != 0:
        raise RuntimeError(f"masked_nn kernel launch failed: cudaError_t {rc}")
    return (idx, best, second), scratch


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
    out = _launch(args, level_window)[0]
    masked_nn.launches += 1
    return out


masked_nn.launches = 0


def masked_nn_tiles(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, levels_a,
                    levels_b, level_window=(-1e9, 1e9)):
    """The kernel on CUDA tensors (not counted in ``masked_nn.launches``),
    returning its outputs and its own preparation as a ``Prepared``, for
    checks of the culling on the card."""
    n, m = desc_a.shape[0], desc_b.shape[0]
    nbytes, offsets, _ = _layout(n, m)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=desc_a.device)
    out, _ = _launch((desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, levels_a, levels_b),
                     level_window, scratch=buf)

    np_, mp = -(-n // TILE) * TILE, -(-m // TILE) * TILE

    def view(name, dtype, shape):
        off = offsets[name]
        return buf[off:off + 4 * shape[0] * shape[1]].view(dtype).view(shape)

    def summary(name, tiles):
        s = view(name, torch.float32, (tiles, 8))
        bits = s.view(torch.int32)
        return TileSummary(box=s[:, :4], lmin=bits[:, 4], lmax=bits[:, 5], count=bits[:, 6])

    prep = Prepared(view("perm_a", torch.int32, (np_, 1))[:, 0].long(),
                    view("perm_b", torch.int32, (mp, 1))[:, 0].long(),
                    summary("rsum", np_ // TILE), summary("csum", mp // TILE))
    return out, prep
