"""The port's native host library (asdslam_torch/native): twins of
tests/test_native.py (the .map serializer byte for byte against the struct
writer, its reader, the prefetching loader), the PNG decoder bit for bit
against the numpy decoders of both packages, the .map bytes against the JAX
package's writer, and a build that fails raising instead of falling back.

The decoder's values are the numpy decoder's (gray levels divided by 255 in
float32).  The reference's C decoder multiplies by 1/255 instead, which
differs by one ulp on 126 of the 256 gray levels; the port keeps its two
routes equal to each other and to the reference's numpy route."""

import struct
import threading
import zlib

import numpy as np
import pytest

from asdslam_tpu.io import datasets as jdatasets
from asdslam_tpu.mapping import persistence as jper
from asdslam_torch.io import datasets as tdatasets
from asdslam_torch.mapping import persistence as tper
from asdslam_torch.native import build as nbuild
from asdslam_torch.native import loader as native
from test_native import _assert_maps_equal, _sample_map, _write_png_gray


# --------------------------------------------------------------------------- #
# twins of tests/test_native.py
# --------------------------------------------------------------------------- #
def test_native_save_matches_python_bytes(tmp_path):
    d = _sample_map()
    p_native, p_python = str(tmp_path / "n.map"), str(tmp_path / "p.map")
    assert native.map_save_native(p_native, d)
    tper.save_visual_map(d, p_python, use_native=False)
    assert open(p_native, "rb").read() == open(p_python, "rb").read()


def test_native_load_roundtrip(tmp_path):
    d = _sample_map()
    path = str(tmp_path / "m.map")
    assert native.map_save_native(path, d)
    back = native.map_load_native(path)
    _assert_maps_equal(d, back)
    _assert_maps_equal(back, tper.load_visual_map(path, use_native=False))


def test_native_load_reads_python_written_imu(tmp_path):
    d = _sample_map(with_imu=True)
    path = str(tmp_path / "imu.map")
    assert not native.map_save_native(path, d)  # the C++ writer does not take IMU payloads
    tper.save_visual_map(d, path)                # so the default route writes them in Python
    back = native.map_load_native(path)
    _assert_maps_equal(d, back)
    assert back.frames[0]["imu"][0][2] == 99.5


def _frames(tmp_path, n, h, w, seed):
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (h, w)).astype(np.uint8) for _ in range(n)]
    paths = []
    for i, im in enumerate(imgs):
        p = str(tmp_path / f"{i:06d}.png")
        _write_png_gray(p, im)
        paths.append(p)
    return imgs, paths


def test_prefetch_loader_ordered(tmp_path):
    imgs, paths = _frames(tmp_path, 10, 24, 32, 1)
    ld = native.PrefetchLoader(paths, 24, 32, n_threads=3, capacity=4)
    got = list(ld)
    ld.close()
    assert len(got) == 10
    for im, fr, p in zip(imgs, got, paths):
        np.testing.assert_allclose(fr, im.astype(np.float32) / 255.0, atol=1e-6)
        np.testing.assert_array_equal(fr, tdatasets.load_image_gray(p))


def test_prefetch_loader_wraparound_race(tmp_path):
    """A small ring, more threads than slots, many frames (the deadlock the
    reference's prefetch.cc fixed in its free_cv predicate)."""
    imgs, paths = _frames(tmp_path, 64, 8, 8, 2)
    for _ in range(5):
        ld = native.PrefetchLoader(paths, 8, 8, n_threads=6, capacity=2)
        got = list(ld)
        ld.close()
        assert len(got) == 64
        for im, fr in zip(imgs, got):
            np.testing.assert_allclose(fr, im.astype(np.float32) / 255.0, atol=1e-6)


# --------------------------------------------------------------------------- #
# The PNG decoder against the numpy decoders
# --------------------------------------------------------------------------- #
def _write_png(path, img, color, filters=(0, 1, 2, 3, 4), depth=8, interlace=0):
    """An 8-bit PNG of ``img`` ([H, W, channels] uint8) with each row's
    filter type taken in turn from ``filters``."""
    h, w, ch = img.shape
    bpp = ch
    rows = []
    prior = np.zeros(w * ch, np.int32)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        ft = filters[y % len(filters)]
        if ft == 0:
            f = line
        elif ft == 1:
            f = line - left
        elif ft == 2:
            f = line - prior
        elif ft == 3:
            f = line - (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
            f = line - pred
        rows.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = line

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)))
        data = zlib.compress(b"".join(rows))
        f.write(chunk(b"IDAT", data[:len(data) // 2]))  # two IDAT chunks
        f.write(chunk(b"IDAT", data[len(data) // 2:]))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("color,channels", [(0, 1), (4, 2), (2, 3), (6, 4)],
                         ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_decode_bitwise(tmp_path, color, channels):
    """Every filter type and every gray level: the native decoder equals the
    port's and the reference's numpy decoders bit for bit, and
    load_image_gray goes through it."""
    g = np.random.default_rng(color)
    img = g.integers(0, 256, (37, 45, channels)).astype(np.uint8)
    img[:6, :, 0] = (np.arange(270) % 256).reshape(6, 45)  # every level, in channel 0
    path = str(tmp_path / "x.png")
    _write_png(path, img, color)
    with open(path, "rb") as f:
        data = f.read()
    before = native.decode_png_gray.decoded
    got = native.decode_png_gray(data)
    assert native.decode_png_gray.decoded == before + 1
    assert got.dtype == np.float32 and got.shape == (37, 45)
    np.testing.assert_array_equal(got, tdatasets._load_png_gray(path))
    np.testing.assert_array_equal(got, jdatasets._load_png_gray(path))
    np.testing.assert_array_equal(tdatasets.load_image_gray(path), got)
    assert native.decode_png_gray.decoded == before + 2


def test_reference_decoder_formula_differs_by_one_ulp():
    """Why the port's decoder divides: the reference's C decoder multiplies
    each gray level by 1/255 in float32, which differs from the numpy
    decoders' division on 126 of the 256 levels, by one ulp each."""
    v = np.arange(256, dtype=np.float32)
    divided, multiplied = v / 255.0, v * (np.float32(1.0) / np.float32(255.0))
    differ = divided != multiplied
    assert int(differ.sum()) == 126
    assert (np.abs(divided - multiplied)[differ] == np.spacing(divided[differ])).all()


def test_png_variants_the_decoder_declines(tmp_path):
    """A 16-bit or an interlaced PNG: the native decoder returns None, as the
    reference's does, and load_image_gray hands it to the numpy reader
    (which refuses these too)."""
    for name, kw in (("deep", dict(depth=16)), ("interlaced", dict(interlace=1))):
        path = str(tmp_path / f"{name}.png")
        _write_png(path, np.zeros((4, 4, 1), np.uint8), 0, **kw)
        with open(path, "rb") as f:
            assert native.decode_png_gray(f.read()) is None
        with pytest.raises(ValueError, match="only 8-bit non-interlaced"):
            tdatasets.load_image_gray(path)


# --------------------------------------------------------------------------- #
# .map files against the JAX package's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("desc_width", [128, 256])
def test_map_bytes_equal_to_the_reference(tmp_path, desc_width):
    d = _sample_map()
    g = np.random.default_rng(desc_width)
    for fr in d.frames:
        fr["descriptors"] = g.standard_normal((len(fr["kps"]), desc_width)).astype(np.float32)
    pj, pn, pd = (str(tmp_path / f"{k}.map") for k in ("jax", "native", "default"))
    jper.save_visual_map(d, pj, use_native=False)
    assert native.map_save_native(pn, d)
    tper.save_visual_map(d, pd)
    ref = open(pj, "rb").read()
    assert open(pn, "rb").read() == ref and open(pd, "rb").read() == ref
    _assert_maps_equal(tper.load_visual_map(pj), jper.load_visual_map(pj, use_native=False))


# --------------------------------------------------------------------------- #
# The build
# --------------------------------------------------------------------------- #
def test_library_is_built_outside_the_package():
    path, _ = nbuild.build()
    assert path.parent == nbuild.HERE.parent.parent / "build" / "native"
    assert path.name.startswith("libasdslam_native-") and path.exists()
    assert not list(nbuild.HERE.glob("*.so"))
    assert native.native_available()


def test_native_load_is_locked(monkeypatch):
    """Four threads at first use: the library is built and loaded once."""
    builds, real = [], nbuild.build

    def slow_build():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)  # a slow build, so the threads overlap
        return real()

    monkeypatch.setattr(nbuild, "build", slow_build)
    monkeypatch.setattr(native, "_lib", None)
    threads = [threading.Thread(target=native.native_available) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and native._lib is not None


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile: build raises with the compiler's log
    and leaves nothing behind, and the loader raises instead of falling back
    to the numpy and struct routes."""
    src = tmp_path / "src"
    src.mkdir()
    for name in nbuild.SOURCES:
        (src / name).write_text("int broken(\n")
    monkeypatch.setattr(nbuild, "HERE", src)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match=r"(?s)native library build failed.*error"):
        nbuild.build()
    assert not list((tmp_path / "out").iterdir())
    monkeypatch.setattr(native, "_lib", None)
    png = str(tmp_path / "a.png")
    _write_png_gray(png, np.zeros((4, 4), np.uint8))
    for call in (native.native_available, lambda: tdatasets.load_image_gray(png),
                 lambda: tper.save_visual_map(_sample_map(), str(tmp_path / "m.map"))):
        with pytest.raises(RuntimeError, match="native library build failed"):
            call()
