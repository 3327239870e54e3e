"""Dataset + camera-config ingestion.

Port of ``asdslam_tpu/io/datasets.py``: PNGs are decoded by the native
library (``asdslam_torch/native``), or by the numpy reader below for the
variants it does not take; PGMs by numpy.
Camera-config parity with src/read_write_data_lib/src/read_write.cpp:27-60
(`CHAMO::read_cam_info`): a text file whose first line is
``fx,fy,cx,cy,k1,k2,p1,p2`` and optional second line is 12 CSV values of the
3x4 body-from-camera transform (see cameraconfig/KITTI/kitti04-12.txt).

KITTI loading follows Examples/Monocular/kitti.cc:56-108 (LoadImages):
``times.txt`` + ``image_0/%06d.png``; EuRoC follows the csv/rosbag layout
(euroc.cc) using ``mav0/cam0/data.csv`` + image files.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

from asdslam_torch.config import SlamConfig
from asdslam_torch.native import loader as native


def read_cam_info(path: str) -> dict:
    """read_write.cpp:27-60 parser parity."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    vals = [float(v) for v in lines[0].split(",")]
    if len(vals) < 8:
        vals = vals + [0.0] * (8 - len(vals))
    out = {
        "fx": vals[0], "fy": vals[1], "cx": vals[2], "cy": vals[3],
        "k1": vals[4], "k2": vals[5], "p1": vals[6], "p2": vals[7],
        "Tbc": np.eye(4),
    }
    if len(lines) > 1:
        tv = [float(v) for v in lines[1].split(",")]
        if len(tv) >= 12:
            T = np.eye(4)
            T[:3, :4] = np.array(tv[:12]).reshape(3, 4)
            out["Tbc"] = T
    return out


def config_from_cam_info(cfg: SlamConfig, info: dict, width: int, height: int) -> SlamConfig:
    return cfg.replace(
        fx=info["fx"], fy=info["fy"], cx=info["cx"], cy=info["cy"],
        dist_coeffs=(info["k1"], info["k2"], info["p1"], info["p2"]),
        image_width=width, image_height=height)


# --------------------------------------------------------------------------- #
# Image decoding (no OpenCV/PIL dependency)
# --------------------------------------------------------------------------- #
def load_image_gray(path: str) -> np.ndarray:
    """Grayscale float32 [0, 1] image from PNG or PGM.  PNGs go through the
    native decoder (the same values as ``_load_png_gray``, bit for bit); a
    variant it does not take (not 8-bit, interlaced) goes to the numpy
    reader, as in the reference."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] in (b"P5", b"P2"):
        return _load_pgm(path)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        out = native.decode_png_gray(data)
        return out if out is not None else _load_png_gray(path)
    raise ValueError(f"unsupported image format: {path}")


def _load_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: P5 <w> <h> <maxval> then raster
    parts = []
    idx = 0
    while len(parts) < 4:
        # skip comments/whitespace
        while idx < len(data) and data[idx:idx + 1].isspace():
            idx += 1
        if data[idx:idx + 1] == b"#":
            while data[idx:idx + 1] != b"\n":
                idx += 1
            continue
        start = idx
        while idx < len(data) and not data[idx:idx + 1].isspace():
            idx += 1
        parts.append(data[start:idx])
    magic, w, h, maxval = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    idx += 1
    if magic == b"P5":
        dt = np.uint8 if maxval < 256 else ">u2"
        img = np.frombuffer(data, dt, count=w * h, offset=idx).reshape(h, w)
    else:
        img = np.array(data[idx:].split(), dtype=np.float32)[:w * h].reshape(h, w)
    return img.astype(np.float32) / float(maxval)


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _load_png_gray(path: str) -> np.ndarray:
    """Minimal PNG decoder: 8-bit grayscale / RGB / RGBA, non-interlaced."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 8
    idat = b""
    meta = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", chunk)
            meta = (w, h, depth, color, interlace)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, interlace = meta
    if depth != 8 or interlace != 0:
        raise ValueError("PNG: only 8-bit non-interlaced supported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = w * channels
    raw = raw.reshape(h, stride + 1)
    ftypes = raw[:, 0]
    lines = raw[:, 1:]
    out = np.zeros((h, stride), np.uint8)
    bpp = channels
    for y in range(h):
        ft = ftypes[y]
        line = lines[y].copy()
        prior = out[y - 1] if y > 0 else np.zeros(stride, np.uint8)
        if ft == 0:
            out[y] = line
        elif ft == 1:  # Sub
            for x in range(stride):
                line[x] = (line[x] + (line[x - bpp] if x >= bpp else 0)) & 0xFF
            out[y] = line
        elif ft == 2:  # Up
            out[y] = (line.astype(np.int32) + prior).astype(np.uint8)
        elif ft == 3:  # Average
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((int(left) + int(prior[x])) >> 1)) & 0xFF
            out[y] = line
        elif ft == 4:  # Paeth
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                ul = prior[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + _paeth(np.uint8(left), prior[x], np.uint8(ul))) & 0xFF
            out[y] = line
        else:
            raise ValueError(f"PNG: unknown filter {ft}")
    img = out.reshape(h, w, channels)
    if channels >= 3:
        gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    else:
        gray = img[..., 0].astype(np.float32)
    return gray.astype(np.float32) / 255.0


# --------------------------------------------------------------------------- #
# Sequence loaders
# --------------------------------------------------------------------------- #
class KittiSequence:
    """Examples/Monocular/kitti.cc LoadImages parity: times.txt + image_0."""

    def __init__(self, seq_dir: str):
        self.dir = seq_dir
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.timestamps = [float(l) for l in f if l.strip()]
        self.image_paths = [
            os.path.join(seq_dir, "image_0", f"{i:06d}.png")
            for i in range(len(self.timestamps))
        ]

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i) -> Tuple[float, np.ndarray]:
        return self.timestamps[i], load_image_gray(self.image_paths[i])


class EurocSequence:
    """mav0/cam0/data.csv + data/<ts>.png."""

    def __init__(self, mav_dir: str):
        cam = os.path.join(mav_dir, "cam0")
        self.timestamps = []
        self.image_paths = []
        with open(os.path.join(cam, "data.csv")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                ts, name = line.strip().split(",")[:2]
                self.timestamps.append(float(ts) * 1e-9)
                self.image_paths.append(os.path.join(cam, "data", name))

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i):
        return self.timestamps[i], load_image_gray(self.image_paths[i])
