"""ctypes bindings of the port's native host library (``native/*.cc``).

Port of ``asdslam_tpu/native/loader.py``.  The library is built at first use
(``native.build``) and loaded once per process.  Nothing here falls back
quietly: a library that fails to build or load raises with the compiler's
log.  What the C code declines by design is reported as the reference
reports it: ``decode_png_gray`` returns None for a PNG variant the decoder
does not take (not 8-bit, interlaced) and ``map_save_native`` returns False
for a map with IMU payloads, and the callers then use their numpy / struct
routes for that input.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from asdslam_torch.native import build as _build

_lib = None
_lock = threading.Lock()
BUILD_LOG = ""  # the compiler's log of the build this process made, if any


def _load():
    """The loaded library with its entry points typed, built first if
    needed; raises if the build or the load fails."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        path, log = _build.build()
        BUILD_LOG = log or BUILD_LOG
        lib = ctypes.CDLL(str(path))
        lib.png_gray_size.restype = ctypes.c_int
        lib.png_gray_size.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.png_decode_gray.restype = ctypes.c_int
        lib.png_decode_gray.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        f32, f64, i32 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_double,
                                                      ctypes.c_int))
        n, text = ctypes.c_int, ctypes.c_char_p
        lib.map_save.restype = ctypes.c_int
        lib.map_save.argtypes = [text, f64, f32, f32, n, f32, n, i32, text, f64, f32, f32, f32,
                                 i32, f32, f32, i32, f32, i32, i32, n, f32, i32, n, f32, f32,
                                 f32, f32, i32, i32]
        lib.map_load_sizes.restype = ctypes.c_int
        lib.map_load_sizes.argtypes = [text, i32]
        lib.map_load_fill.restype = ctypes.c_int
        lib.map_load_fill.argtypes = [text, f64, f32, f32, f32, i32, ctypes.c_char_p, f64, f32,
                                      f32, f32, i32, f32, f32, i32, f32, i32, i32, f32, i32,
                                      f32, f64, i32, f32, f32, f32, f32, i32, i32]
        _lib = lib
        return lib


def native_available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return _load() is not None


def decode_png_gray(data: bytes) -> Optional[np.ndarray]:
    """Decode PNG bytes to float32 [H, W] in [0, 1] (the numpy decoder's
    values, bit for bit), or None for a variant the decoder does not take.
    Each decoded image adds one to ``decode_png_gray.decoded``."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.png_gray_size(bp, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.png_decode_gray(bp, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    with _lock:
        decode_png_gray.decoded += 1
    return out


decode_png_gray.decoded = 0


class PrefetchLoader:
    """Ordered, multi-threaded PNG frame loader (native/prefetch.cc).

    Iterates float32 [H, W] frames in [0, 1], decoded ahead of the consumer
    by a C++ worker pool, so the device's frame step never waits on disk or
    inflate.
    """

    def __init__(self, paths, height: int, width: int,
                 n_threads: int = 4, capacity: int = 8):
        self._handle = None
        lib = _load()
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        self._n = len(paths)
        self._h, self._w = height, width
        arr = (ctypes.c_char_p * self._n)(*self._paths)
        self._handle = lib.loader_create(arr, self._n, n_threads, capacity, width, height)
        if not self._handle:
            raise RuntimeError("loader_create failed")

    def __len__(self):
        return self._n

    def __iter__(self):
        out = np.empty((self._h, self._w), np.float32)
        while True:
            rc = self._lib.loader_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc == -1:
                return
            if rc == -2:
                raise IOError("frame decode failed")
            yield out.copy()

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class _Keep:
    """Pointer helpers that keep converted arrays alive until the C call
    returns (np.ascontiguousarray may allocate a temporary; a bare
    .ctypes.data_as pointer would dangle)."""

    def __init__(self):
        self.refs = []

    def _ptr(self, a, dtype, ctype):
        a = np.ascontiguousarray(a, dtype)
        self.refs.append(a)
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    def f32(self, a):
        return self._ptr(a, np.float32, ctypes.c_float)

    def i32(self, a):
        return self._ptr(a, np.int32, ctypes.c_int)

    def f64(self, a):
        return self._ptr(a, np.float64, ctypes.c_double)


def map_save_native(path: str, data) -> bool:
    """Write a VisualMapData through the C++ serializer (native/mapio.cc),
    byte for byte the struct writer's file.  Returns False, writing nothing,
    for a map with IMU payloads (the C++ writer does not take them); raises
    OSError if the file cannot be written."""
    if any(fr.get("imu") for fr in data.frames):
        return False
    lib = _load()
    F = len(data.frames)
    names = b"".join(fr["file_name"].encode() for fr in data.frames)
    name_lens = np.array([len(fr["file_name"].encode()) for fr in data.frames], np.int32)
    ts = np.array([fr["time_stamp"] for fr in data.frames], np.float64)
    pos = np.stack([fr["position"] for fr in data.frames]) if F else np.zeros((0, 3), np.float32)
    quat = np.stack([fr["direction"] for fr in data.frames]) if F else np.zeros((0, 4), np.float32)
    intr = np.array([[fr[k] for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")]
                     for fr in data.frames], np.float32).reshape(F, 8)
    wh = np.array([[fr["width"], fr["height"]] for fr in data.frames], np.int32).reshape(F, 2)
    gps = np.stack([fr["gps_position"] for fr in data.frames]) if F else np.zeros((0, 3), np.float32)
    gacc = np.array([fr["gps_accu"] for fr in data.frames], np.float32)
    kp_counts = np.array([len(fr["kps"]) for fr in data.frames], np.int32)
    total = int(kp_counts.sum())
    kps = (np.concatenate([fr["kps"] for fr in data.frames])
           if total else np.zeros((0, 2), np.float32))
    obs = (np.concatenate([fr["obs_mp"] for fr in data.frames])
           if total else np.zeros(0, np.int32))
    octv = (np.concatenate([fr["octave"] for fr in data.frames])
            if total else np.zeros(0, np.int32))
    dw = 0
    for fr in data.frames:
        if len(fr["descriptors"]):
            dw = fr["descriptors"].shape[1]
            break
    descs = (np.concatenate([fr["descriptors"].reshape(-1, dw) for fr in data.frames])
             if total and dw else np.zeros((0, max(dw, 1)), np.float32))
    imu_next = np.array([fr.get("imu_next_frame", -1) for fr in data.frames], np.int32)
    E = len(data.edge_v1)
    keep = _Keep()
    rc = lib.map_save(
        path.encode(), keep.f64(data.gps_anchor), keep.f32(data.tbc_posi),
        keep.f32(data.tbc_quat), ctypes.c_int(len(data.mp_positions)),
        keep.f32(data.mp_positions), ctypes.c_int(F),
        keep.i32(name_lens), ctypes.c_char_p(names), keep.f64(ts), keep.f32(pos),
        keep.f32(quat), keep.f32(intr), keep.i32(wh), keep.f32(gps), keep.f32(gacc),
        keep.i32(kp_counts), keep.f32(kps), keep.i32(obs), keep.i32(octv),
        ctypes.c_int(dw), keep.f32(descs), keep.i32(imu_next),
        ctypes.c_int(E), keep.f32(data.edge_posi), keep.f32(data.edge_quat),
        keep.f32(data.edge_scale), keep.f32(data.edge_weight),
        keep.i32(data.edge_v1), keep.i32(data.edge_v2))
    if rc != 0:
        raise OSError(f"map_save_native: cannot write {path} (code {rc})")
    return True


def map_load_native(path: str):
    """Read a .map through the C++ deserializer (IMU payloads included);
    returns a VisualMapData, or raises OSError if the file cannot be read
    or parsed."""
    from asdslam_torch.mapping.persistence import VisualMapData

    lib = _load()
    sizes = (ctypes.c_int * 7)()
    if lib.map_load_sizes(path.encode(), sizes) != 0:
        raise OSError(f"map_load_native: cannot read {path}")
    n_mp, F, total_kps, dw, total_names, total_imu, E = [sizes[i] for i in range(7)]
    d = VisualMapData()
    d.gps_anchor = np.zeros(3, np.float64)
    d.tbc_posi = np.zeros(3, np.float32)
    d.tbc_quat = np.zeros(4, np.float32)
    d.mp_positions = np.zeros((n_mp, 3), np.float32)
    name_lens = np.zeros(F, np.int32)
    name_bytes = ctypes.create_string_buffer(max(total_names, 1))
    ts = np.zeros(F, np.float64)
    pos = np.zeros((F, 3), np.float32)
    quat = np.zeros((F, 4), np.float32)
    intr = np.zeros((F, 8), np.float32)
    wh = np.zeros((F, 2), np.int32)
    gps = np.zeros((F, 3), np.float32)
    gacc = np.zeros(F, np.float32)
    kp_counts = np.zeros(F, np.int32)
    kps = np.zeros((total_kps, 2), np.float32)
    obs = np.zeros(total_kps, np.int32)
    octv = np.zeros(total_kps, np.int32)
    descs = np.zeros((total_kps, max(dw, 1)), np.float32)
    imu_counts = np.zeros(F, np.int32)
    imu_data = np.zeros((total_imu, 6), np.float32)
    imu_ts = np.zeros(total_imu, np.float64)
    imu_next = np.zeros(F, np.int32)
    d.edge_posi = np.zeros((E, 3), np.float32)
    d.edge_quat = np.zeros((E, 4), np.float32)
    d.edge_scale = np.zeros(E, np.float32)
    d.edge_weight = np.zeros(E, np.float32)
    d.edge_v1 = np.zeros(E, np.int32)
    d.edge_v2 = np.zeros(E, np.int32)
    keep = _Keep()
    rc = lib.map_load_fill(
        path.encode(), keep.f64(d.gps_anchor), keep.f32(d.tbc_posi), keep.f32(d.tbc_quat),
        keep.f32(d.mp_positions), keep.i32(name_lens), name_bytes, keep.f64(ts),
        keep.f32(pos), keep.f32(quat), keep.f32(intr), keep.i32(wh), keep.f32(gps), keep.f32(gacc),
        keep.i32(kp_counts), keep.f32(kps), keep.i32(obs), keep.i32(octv), keep.f32(descs),
        keep.i32(imu_counts), keep.f32(imu_data), keep.f64(imu_ts), keep.i32(imu_next),
        keep.f32(d.edge_posi), keep.f32(d.edge_quat), keep.f32(d.edge_scale),
        keep.f32(d.edge_weight), keep.i32(d.edge_v1), keep.i32(d.edge_v2))
    if rc != 0:
        raise OSError(f"map_load_native: cannot parse {path} (code {rc})")
    raw = name_bytes.raw[:total_names]
    off = kp_off = imu_off = 0
    for i in range(F):
        nl, nk, ni = int(name_lens[i]), int(kp_counts[i]), int(imu_counts[i])
        imu = [(tuple(imu_data[imu_off + j, :3]), tuple(imu_data[imu_off + j, 3:6]),
                float(imu_ts[imu_off + j])) for j in range(ni)]
        d.frames.append(dict(
            file_name=raw[off:off + nl].decode(), time_stamp=float(ts[i]),
            position=pos[i].copy(), direction=quat[i].copy(),
            fx=float(intr[i, 0]), fy=float(intr[i, 1]), cx=float(intr[i, 2]),
            cy=float(intr[i, 3]), k1=float(intr[i, 4]), k2=float(intr[i, 5]),
            p1=float(intr[i, 6]), p2=float(intr[i, 7]),
            width=int(wh[i, 0]), height=int(wh[i, 1]),
            gps_position=gps[i].copy(), gps_accu=float(gacc[i]),
            kps=kps[kp_off:kp_off + nk].copy(), obs_mp=obs[kp_off:kp_off + nk].copy(),
            octave=octv[kp_off:kp_off + nk].copy(),
            descriptors=descs[kp_off:kp_off + nk].copy() if dw else np.zeros((nk, 0), np.float32),
            imu=imu, imu_next_frame=int(imu_next[i])))
        off += nl
        kp_off += nk
        imu_off += ni
    return d
