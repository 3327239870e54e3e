"""Parity of the port's persistence layer with the JAX package's:
``mapping/persistence.py`` (the ``.map`` file, export from a store, import
into one), ``io/results.py`` (the plain-text dump and its readers) and
``io/datasets.py`` (the camera file, the image decoders, the sequence
layouts), on the same inputs.

Bars: files byte-identical, both ways; imported stores equal array by
array (float32 values bitwise: both packages run the same numpy code on the
same bytes); decoded images equal to the JAX package's numpy decoders
bitwise and to its default decoder within 1e-6.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from asdslam_tpu.config import SlamConfig as JConfig
from asdslam_tpu.io import datasets as jdata
from asdslam_tpu.io import results as jres
from asdslam_tpu.mapping import persistence as jper
from asdslam_tpu.mapping.map_store import MapStore as JStore
from asdslam_tpu.models import patch_descriptor as jpatch
from asdslam_tpu.system import System as JSystem
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.io import datasets as tdata
from asdslam_torch.io import results as tres
from asdslam_torch.mapping import persistence as tper
from asdslam_torch.mapping.map_store import MapStore as TStore
from test_persistence import make_data
from test_torch_mapping import SMALL, render_u8, snapshot, torch_store

SCALES = np.array([1.2 ** i for i in range(8)], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_store():
    """A JAX System's store after 14 frames of the corridor (synchronous,
    patch descriptor), and the same state as a port store."""
    cfg = JConfig(**SMALL)
    frames_u8, _ = render_u8(cfg, 14)
    system = JSystem(cfg, descriptor_fn=jpatch.apply)
    for i in range(14):
        system.track_monocular(frames_u8[i], i)
    store = system.store
    assert store.n_kf >= 3 and store.mp_valid.sum() > 200, system.stats()
    return cfg, store, torch_store(snapshot(store))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_maps_equal(a, b):
    assert a.gps_anchor.tobytes() == b.gps_anchor.tobytes()
    for name in ("tbc_posi", "tbc_quat", "mp_positions", "edge_posi", "edge_quat",
                 "edge_scale", "edge_weight", "edge_v1", "edge_v2"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        assert fa.keys() == fb.keys()
        for k in fa:
            if k == "imu":
                assert [tuple(np.asarray(x).tolist() for x in e) for e in fa[k]] == \
                    [tuple(np.asarray(x).tolist() for x in e) for e in fb[k]]
            else:
                np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


# --------------------------------------------------------------------------- #
# The .map file
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("jax_writer", ["python", "default"])
def test_visual_map_bytes_both_ways(tmp_path, jax_writer):
    """tests/test_persistence.py's make_data() written by both packages (the
    JAX one through its Python writer, and through its default route, the
    native writer where it is built): the same bytes; each package reads
    the other's file to the same data."""
    d = make_data()
    pj, pt = str(tmp_path / "jax.map"), str(tmp_path / "torch.map")
    jper.save_visual_map(d, pj, **({"use_native": False} if jax_writer == "python" else {}))
    tper.save_visual_map(d, pt)
    assert read(pj) == read(pt)
    assert_maps_equal(tper.load_visual_map(pj), jper.load_visual_map(pt, use_native=False))
    assert_maps_equal(tper.load_visual_map(pt), jper.load_visual_map(pj))
    # and a round trip through the port alone writes the same file again
    tper.save_visual_map(tper.load_visual_map(pt), str(tmp_path / "again.map"))
    assert read(str(tmp_path / "again.map")) == read(pt)


def test_export_map_bytes(tmp_path, jax_store):
    """export_map + save_visual_map from one recorded state: the same file."""
    cfg, jstore, tstore = jax_store
    tcfg = TConfig(**SMALL)
    jd = jper.export_map(jstore, cfg, cfg.covis_weight_posegraph)
    td = tper.export_map(tstore, tcfg, tcfg.covis_weight_posegraph)
    assert len(td.frames) == int(jstore.kf_valid.sum()) and len(td.edge_v1) > 0
    assert_maps_equal(jd, td)
    pj, pt = str(tmp_path / "jax.map"), str(tmp_path / "torch.map")
    jper.save_visual_map(jd, pj, use_native=False)
    tper.save_visual_map(td, pt)
    assert read(pj) == read(pt)
    # the reference's quirks, kept: distortion written as 0, keypoints from
    # uv_und, 128-wide descriptors
    fr = tper.load_visual_map(pt).frames[0]
    assert (fr["k1"], fr["k2"], fr["p1"], fr["p2"]) == (0.0, 0.0, 0.0, 0.0)
    assert fr["descriptors"].shape[1] == 128


def test_import_map_equal_stores(tmp_path, jax_store):
    """One file imported into a store of each package: keyframes, points,
    observations, distinctive descriptors, normals, depth ranges and the
    prior-map flags all equal."""
    cfg, jstore, _ = jax_store
    path = str(tmp_path / "m.map")
    jper.save_visual_map(jper.export_map(jstore, cfg, cfg.covis_weight_posegraph), path,
                         use_native=False)
    shape = (cfg.max_keyframes, cfg.max_map_points, cfg.n_features, cfg.max_obs_per_point)
    js, ts = JStore(*shape), TStore(*shape)
    jremap = jper.import_map(jper.load_visual_map(path, use_native=False), js, SCALES)
    tremap = tper.import_map(tper.load_visual_map(path), ts, SCALES, device="cpu")
    assert jremap == tremap
    assert ts.n_kf == js.n_kf == int(jstore.kf_valid.sum())
    assert ts.mp_valid.sum() > 200
    for name in TStore.ARRAYS + ("n_kf", "n_mp"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name), err_msg=name)
    assert ts.kf_global[:ts.n_kf].all() and ts.mp_global[ts.mp_valid].all()
    for (ja, ta) in zip(js.kf_host, ts.kf_host):
        for x, y in zip(ja, ta):
            np.testing.assert_array_equal(y, x)
    for jf, tf in zip(js.kf_features, ts.kf_features):
        for name in tf._fields:
            np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                          np.asarray(getattr(jf, name)), err_msg=name)
    # the loaded keyframes' features as the matchers read them
    assert ts.kf_features[0].desc.dtype == torch.float32
    assert ts.kf_features[0].desc.shape == (cfg.n_features, 128)


# --------------------------------------------------------------------------- #
# The plain-text dump
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("names", [False, True])
def test_save_result_text_identical(tmp_path, jax_store, names):
    cfg, jstore, tstore = jax_store
    filenames = ({int(f): f"/data/seq/{int(f):06d}.png" for f in jstore.kf_frame_id[:jstore.n_kf]}
                 if names else None)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres.save_result(jstore, dj, filenames)
    tres.save_result(tstore, dt, filenames)
    for name in ("traj", "track", "posi", "kps", "desc"):
        text = read(os.path.join(dt, name + ".txt"))
        assert text == read(os.path.join(dj, name + ".txt")), name
        assert text, name
    # the readers agree on the files
    for fn, name in (("read_traj_file", "traj"), ("read_mp_posi", "posi"),
                     ("read_kp_info", "kps"), ("read_track_info", "track"),
                     ("read_desc", "desc")):
        ja = getattr(jres, fn)(os.path.join(dj, name + ".txt"))
        ta = getattr(tres, fn)(os.path.join(dt, name + ".txt"))
        ja, ta = (ja, ta) if isinstance(ja, tuple) else ((ja,), (ta,))
        for x, y in zip(ja, ta):
            if isinstance(x, list):  # names, and the ragged tracks
                assert y == x, fn
            else:
                np.testing.assert_array_equal(y, x, err_msg=fn)
    # an empty store writes five empty files in both packages
    tres.save_result(TStore(4, 16, 8), str(tmp_path / "empty"))
    assert all(read(str(tmp_path / "empty" / (n + ".txt"))) == b""
               for n in ("traj", "track", "posi", "kps", "desc"))


def test_result_readers(tmp_path):
    """The readers the dump has no writer for: image times, IMU, GPS."""
    files = {"times.txt": "a.png,0.5\nb.png,0.75\n",
             "imu.txt": "0.1,1,2,3,4,5,6\n0.2,1,2,3,4,5,7.5\n",
             "gps.txt": "10,20,30\n0.5,1,2,3,4\n0.6,1.5,2.5,3.5,2\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    for fn, name in (("read_img_time", "times.txt"), ("read_imu_data", "imu.txt"),
                     ("read_gps_orth", "gps.txt")):
        ja = getattr(jres, fn)(str(tmp_path / name))
        ta = getattr(tres, fn)(str(tmp_path / name))
        ja, ta = (ja, ta) if isinstance(ja, tuple) else ((ja,), (ta,))
        for x, y in zip(ja, ta):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


# --------------------------------------------------------------------------- #
# Datasets: the camera file, the decoders, the sequence layouts
# --------------------------------------------------------------------------- #
def write_png(path, img_u8, filters):
    """An 8-bit PNG (gray [H, W] or RGB [H, W, 3]) whose row y is encoded
    with filter ``filters[y % len(filters)]`` (0 none, 1 Sub, 2 Up,
    3 Average, 4 Paeth)."""
    img = img_u8.reshape(img_u8.shape[0], -1).astype(np.int32)
    bpp = 1 if img_u8.ndim == 2 else img_u8.shape[2]
    h, stride = img.shape
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        line, prior = img[y], (img[y - 1] if y else np.zeros(stride, np.int32))
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if ft == 0:
            pred = np.zeros(stride, np.int32)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        rows.append(bytes([ft]) + ((line - pred) % 256).astype(np.uint8).tobytes())

    def chunk(ctype, data):
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    color = 0 if bpp == 1 else 2
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", img_u8.shape[1], h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray all filters", "rgb all filters", "pgm P5", "pgm P2"])
def test_image_decoders(tmp_path, kind):
    g = np.random.default_rng(len(kind))
    if kind.startswith("pgm"):
        img = (g.uniform(size=(10, 12)) * 255).astype(np.uint8)
        path = str(tmp_path / "t.pgm")
        with open(path, "wb") as f:
            if kind == "pgm P5":
                f.write(b"P5\n# a comment\n12 10\n255\n" + img.tobytes())
            else:
                f.write(b"P2\n12 10\n255\n" + " ".join(map(str, img.ravel())).encode())
        np.testing.assert_array_equal(tdata.load_image_gray(path), jdata._load_pgm(path))
    else:
        shape = (23, 17) if kind.startswith("gray") else (13, 11, 3)
        img = (g.uniform(size=shape) * 255).astype(np.uint8)
        path = str(tmp_path / "t.png")
        write_png(path, img, filters=[0, 1, 2, 3, 4])
        out = tdata.load_image_gray(path)
        np.testing.assert_array_equal(out, jdata._load_png_gray(path))
        np.testing.assert_allclose(out, jdata.load_image_gray(path), rtol=0, atol=1e-6)
        if img.ndim == 2:
            np.testing.assert_array_equal(out, img.astype(np.float32) / 255.0)
    with pytest.raises(ValueError):
        (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(20))
        tdata.load_image_gray(str(tmp_path / "x.bmp"))


def test_cam_info_and_sequences(tmp_path):
    """The camera file (EuRoC's radtan line with a body-from-camera line, a
    KITTI line with fewer than eight values) and both sequence layouts."""
    euroc = tmp_path / "euroc.txt"
    euroc.write_text("458.654,457.296,367.215,248.375,-0.28340811,0.07395907,0.00019359,"
                     "1.76187114e-05\n\n1,0,0,0.1,0,1,0,0.2,0,0,1,0.3\n")
    kitti = tmp_path / "kitti.txt"
    kitti.write_text("718.856,718.856,607.1928,185.2157\n")
    for path, (w, h) in ((euroc, (752, 480)), (kitti, (1241, 376))):
        ji, ti = jdata.read_cam_info(str(path)), tdata.read_cam_info(str(path))
        assert ji.keys() == ti.keys()
        for k in ji:
            np.testing.assert_array_equal(ti[k], ji[k])
        jc = jdata.config_from_cam_info(JConfig(), ji, w, h)
        tc = tdata.config_from_cam_info(TConfig(), ti, w, h)
        assert jc.dist_coeffs == tc.dist_coeffs and jc.undistorted_bounds == tc.undistorted_bounds
        assert (tc.fx, tc.fy, tc.cx, tc.cy, tc.image_width, tc.image_height) == \
            (jc.fx, jc.fy, jc.cx, jc.cy, jc.image_width, jc.image_height)
        assert tc.has_distortion == (path == euroc)

    img = (np.random.default_rng(3).uniform(size=(8, 9)) * 255).astype(np.uint8)
    seq = tmp_path / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "times.txt").write_text("0.0\n0.1\n\n")
    for i in range(2):
        write_png(str(seq / "image_0" / f"{i:06d}.png"), img, filters=[i])
    mav = tmp_path / "mav0"
    (mav / "cam0" / "data").mkdir(parents=True)
    (mav / "cam0" / "data.csv").write_text(
        "#timestamp [ns],filename\n1403636579763555584,a.png\n1403636579813555456,b.png\n")
    for name in ("a.png", "b.png"):
        write_png(str(mav / "cam0" / "data" / name), img, filters=[4])
    for jseq, tseq in ((jdata.KittiSequence(str(seq)), tdata.KittiSequence(str(seq))),
                       (jdata.EurocSequence(str(mav)), tdata.EurocSequence(str(mav)))):
        assert len(tseq) == len(jseq) == 2
        assert tseq.timestamps == jseq.timestamps and tseq.image_paths == jseq.image_paths
        for i in range(2):
            (tt, ti), (jt, ji) = tseq[i], jseq[i]
            assert tt == jt
            np.testing.assert_array_equal(ti, img.astype(np.float32) / 255.0)
            np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-6)
