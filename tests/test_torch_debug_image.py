"""The port's debug image (System.save_debug_image, viz.draw_debug_overlay,
viz.write_png_rgb) against the JAX package's matplotlib figure, on the CPU.

The JAX package draws with matplotlib (anti-aliased, its size moved by
``bbox_inches="tight"``); the port draws the same markers into an array
with a bitmap font.  The bar is not the pixels of the figure but what it
shows: the returned dict (counts equal, the mean reprojection error within
1e-4 px: both packages run the same numpy projection over the same store,
the port with float32 intrinsics), the title (equal strings), and the marker
positions (the rounded positions of the reference's two scatters carry the
port's lime and red pixels).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from asdslam_tpu.config import SlamConfig as JConfig
from asdslam_tpu.models import patch_descriptor as jpatch
from asdslam_tpu.system import System as JSystem
from asdslam_torch import viz
from asdslam_torch.config import SlamConfig as TConfig
from asdslam_torch.models import patch_descriptor as tpatch
from asdslam_torch.system import System as TSystem
from test_torch_mapping import SMALL, render_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPROJ_BAR_PX = 1e-4
LIME, RED = np.array(viz.LIME), np.array(viz.RED)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """A .map of a JAX System's 14 corridor frames (synchronous, patch
    descriptor) loaded into a fresh System of each package, with the last
    frame as the backdrop."""
    cfg = JConfig(**SMALL)
    frames_u8, _ = render_u8(cfg, 14)
    system = JSystem(cfg, descriptor_fn=jpatch.apply)
    for i in range(14):
        system.track_monocular(frames_u8[i], i)
    path = str(tmp_path_factory.mktemp("map") / "run.map")
    system.save_map(path)
    jsys = JSystem(cfg, descriptor_fn=jpatch.apply)
    jsys.load_map(path)
    tsys = TSystem(TConfig(**SMALL), descriptor_fn=tpatch.apply, device="cpu")
    tsys.load_map(path)
    assert tsys.store.n_kf >= 3 and tsys.debug_info()[0]["n_matches"] > 100
    return jsys, tsys, frames_u8[-1].astype(np.float32) / 255.0


def reference_figure(jsys, path, image, monkeypatch):
    """The JAX package's save_debug_image, with its title and the positions
    of its two scatters recorded."""
    from matplotlib.axes import Axes

    seen = {"scatter": []}
    real_scatter, real_title = Axes.scatter, Axes.set_title

    def scatter(ax, x, y, *a, **kw):
        seen["scatter"].append((kw.get("c"), np.stack([np.asarray(x), np.asarray(y)], 1)))
        return real_scatter(ax, x, y, *a, **kw)

    def set_title(ax, label, *a, **kw):
        seen["title"] = label
        return real_title(ax, label, *a, **kw)

    monkeypatch.setattr(Axes, "scatter", scatter)
    monkeypatch.setattr(Axes, "set_title", set_title)
    info = jsys.save_debug_image(path, image=image)
    return info, seen


def read_png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")), dict(im.text), im.mode


def footprint_pixels(centres_uv, footprint, h, w):
    c = np.rint(np.asarray(centres_uv, np.float64)[:, ::-1]).astype(np.int64)
    px = (c[:, None, :] + footprint[None]).reshape(-1, 2)
    px = px[(px[:, 0] >= 0) & (px[:, 0] < h) & (px[:, 1] >= 0) & (px[:, 1] < w)]
    return {tuple(p) for p in px}


@pytest.mark.parametrize("with_backdrop", [False, True])
def test_same_dict_title_and_markers_as_reference(loaded, tmp_path, monkeypatch, with_backdrop):
    jsys, tsys, frame = loaded
    image = frame if with_backdrop else None
    jinfo, seen = reference_figure(jsys, str(tmp_path / "j.png"), image, monkeypatch)
    tinfo = tsys.save_debug_image(str(tmp_path / "t.png"), image=image)
    for key in ("n_matches", "n_keyframes", "n_map_points", "n_frames_tracked", "state"):
        assert tinfo[key] == jinfo[key], key
    assert abs(tinfo["mean_reproj_err"] - jinfo["mean_reproj_err"]) < REPROJ_BAR_PX
    img, text, mode = read_png(str(tmp_path / "t.png"))
    assert mode == "RGB" and text == {"Title": seen["title"]}
    h, w = SMALL["image_height"], SMALL["image_width"]
    assert img.shape == (h + viz.BAND_H, w, 3)
    (c_obs, obs), (c_proj, proj) = seen["scatter"]
    assert (c_obs, c_proj) == ("lime", "red") and len(obs) == len(proj) == jinfo["n_matches"]
    crosses = footprint_pixels(proj, viz.CROSS, h, w)
    for v, u in footprint_pixels(obs, np.zeros((1, 2), np.int64), h, w):
        assert (v, u) in crosses or (img[v, u] == LIME).all(), (v, u)
    for v, u in footprint_pixels(proj, np.zeros((1, 2), np.int64), h, w):
        assert (img[v, u] == RED).all(), (v, u)


def test_markers_on_a_blank_canvas():
    """Every rounded observed uv is lime unless a cross covers it, every
    rounded reprojection red, markers off the canvas are clipped, and no
    other pixel of the image is lit."""
    g = np.random.default_rng(0)
    obs = g.uniform(-5, 130, (60, 2))
    proj = obs + g.normal(0, 3, (60, 2))
    ok = g.random(60) < 0.8
    img = viz.draw_debug_overlay((90, 120), obs, proj, ok, "reproj err 1.00 px, 48 matches, "
                                 "3 KFs, 400 MPs")
    body = img[:90]
    discs = footprint_pixels(obs[ok], viz.DISC, 90, 120)
    crosses = footprint_pixels(proj[ok], viz.CROSS, 90, 120)
    lit = {tuple(p) for p in np.argwhere(body.any(axis=2))}
    assert lit == discs | crosses
    for v, u in crosses:
        assert (body[v, u] == RED).all()
    for v, u in discs - crosses:
        assert (body[v, u] == LIME).all()
    inside = footprint_pixels(obs[ok], np.zeros((1, 2), np.int64), 90, 120)
    assert len(inside) < ok.sum()          # some centres fall off the canvas


def test_backdrop_kept_away_from_markers(loaded):
    jsys, tsys, frame = loaded
    info, proj, obs, ok = tsys.debug_info()
    img = viz.draw_debug_overlay(frame.shape, obs, proj, ok, viz.debug_caption(info),
                                 backdrop=frame)
    h, w = frame.shape
    gray = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
    marked = footprint_pixels(obs[ok], viz.DISC, h, w) | footprint_pixels(proj[ok], viz.CROSS,
                                                                          h, w)
    keep = np.ones((h, w), bool)
    keep[tuple(np.array(sorted(marked)).T)] = False
    for c in range(3):
        np.testing.assert_array_equal(img[:h, :, c][keep], gray[keep])
    assert keep.sum() < h * w


def test_empty_system_writes_the_blank_canvas(tmp_path):
    """No keyframe: a black canvas and the band, n_matches 0 and a NaN
    error, as the reference's dict."""
    jinfo = JSystem(JConfig(**SMALL), descriptor_fn=jpatch.apply).save_debug_image(
        str(tmp_path / "j.png"))
    tinfo = TSystem(TConfig(**SMALL), descriptor_fn=tpatch.apply, device="cpu"
                    ).save_debug_image(str(tmp_path / "t.png"))
    assert tinfo["n_matches"] == jinfo["n_matches"] == 0
    assert np.isnan(tinfo["mean_reproj_err"]) and np.isnan(jinfo["mean_reproj_err"])
    assert {k: v for k, v in tinfo.items() if k != "mean_reproj_err"} == \
        {k: v for k, v in jinfo.items() if k != "mean_reproj_err"}
    img, text, _ = read_png(str(tmp_path / "t.png"))
    assert text["Title"] == "reproj err nan px, 0 matches, 0 KFs, 0 MPs"
    assert not img[:SMALL["image_height"]].any() and img[SMALL["image_height"]:].any()


@pytest.mark.parametrize("shape", [(5, 7), (48, 300)])
def test_png_decodes_to_the_array(tmp_path, shape):
    g = np.random.default_rng(shape[0])
    a = g.integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    viz.write_png_rgb(path, a, text="reproj err 0.25 px, 7 matches, 2 KFs, 90 MPs")
    img, text, mode = read_png(path)
    assert mode == "RGB" and text == {"Title": "reproj err 0.25 px, 7 matches, 2 KFs, 90 MPs"}
    np.testing.assert_array_equal(img, a)
    viz.write_png_rgb(path, a)
    assert read_png(path)[1] == {}
    with pytest.raises(ValueError):
        viz.write_png_rgb(path, a[..., 0])


@pytest.mark.parametrize("err,n", [(0.5349, 123), (float("nan"), 0), (float("inf"), 7),
                                   (12345.678, 99999)])
def test_caption_glyphs(err, n):
    """The reference's title for any numbers, and both legend words, have a
    glyph for every character; another character raises."""
    info = dict(mean_reproj_err=err, n_matches=n, n_keyframes=n + 1, n_map_points=10 * n)
    caption = viz.debug_caption(info)
    assert caption == "reproj err %.2f px, %d matches, %d KFs, %d MPs" % (err, n, n + 1, 10 * n)
    canvas = np.zeros((10, 6 * len(caption) + 4, 3), np.uint8)
    viz.draw_text(canvas, 2, 2, caption + "observed reprojected")
    assert canvas.any()
    with pytest.raises(ValueError, match="glyph"):
        viz.draw_text(canvas, 0, 0, "Q")


def test_without_matplotlib(tmp_path):
    """The port writes the image in a process where matplotlib cannot be
    imported at all."""
    path = str(tmp_path / "dbg.png")
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "from asdslam_torch.config import SlamConfig\n"
        "from asdslam_torch.models import patch_descriptor\n"
        "from asdslam_torch.system import System\n"
        f"s = System(SlamConfig(**{SMALL!r}), descriptor_fn=patch_descriptor.apply, "
        "device='cpu')\n"
        f"info = s.save_debug_image({path!r})\n"
        "assert info['n_matches'] == 0\n"
        "assert 'matplotlib' not in [m for m in sys.modules if sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    img, text, _ = read_png(path)
    assert img.shape == (SMALL["image_height"] + viz.BAND_H, SMALL["image_width"], 3)
