"""The port's measurement twins, mfu_bench_torch.py and
profile_stages_torch.py, and the peak rates they share with chip_smoke.py
(asdslam_torch/utils/roofline.py), on the CPU.

The work counts are held to the JAX scripts' own expressions, read from
mfu_bench.py's source (importing it would import JAX and set its
compilation cache): ASDNet's FLOPs and bytes, local BA's FLOPs and bytes
and the fused step's FLOPs equal.  The stated departures are the
matcher's: its bytes the inputs and outputs once (in its rows and the
step's), its rows' FLOPs the gated-in pairs' dot products, both counted by
the roofline module that chip_smoke.py's kernel bound reads.  Times need
the card: here the rows carry ms, GFLOP and MB, and every share is null.
"""

import ast
import contextlib
import io
import json
import os
import re
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mfu_bench_torch  # noqa: E402
import profile_stages_torch  # noqa: E402
from asdslam_torch.config import SlamConfig  # noqa: E402
from asdslam_torch.utils import roofline  # noqa: E402

TINY = dict(image_width=160, image_height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
            n_features=200, n_levels=3, local_ba_max_points=256, local_ba_max_obs=1024)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_counts():
    """mfu_bench.py's ``asdnet_flops`` and, in source order, the
    expressions main() assigns to flops, bytes_, act, no and img_b."""
    tree = ast.parse(open(os.path.join(ROOT, "mfu_bench.py")).read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    ns = {}
    exec(compile(ast.Module(body=[funcs["asdnet_flops"]], type_ignores=[]), "mfu_bench", "exec"),
         ns)
    exprs = {}
    assigns = [n for n in ast.walk(funcs["main"])
               if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)]
    for node in sorted(assigns, key=lambda n: n.lineno):
        exprs.setdefault(node.targets[0].id, []).append(node.value)
    return ns["asdnet_flops"], exprs


def evaluate(expr, **names):
    return eval(compile(ast.Expression(body=expr), "mfu_bench", "eval"), dict(names))


@pytest.mark.parametrize("n", [1, 2000])
def test_asdnet_counts_equal_reference(n):
    ref_flops, exprs = reference_counts()
    assert mfu_bench_torch.asdnet_flops(n) == ref_flops(n)
    act = evaluate(exprs["act"][0], n_p=n)
    assert mfu_bench_torch.asdnet_bytes(n) == act * 2


@pytest.mark.parametrize("cfg", [SlamConfig(), SlamConfig(**TINY)], ids=["kitti", "tiny"])
def test_ba_and_step_counts_equal_reference(cfg):
    ref_flops, exprs = reference_counts()
    # the reference's BA row: no, then its flops and bytes (the third of each)
    no = evaluate(exprs["no"][0], cfg=cfg)
    pt, o = mfu_bench_torch.BA_SHAPE
    names = dict(iters=15, O=o, Pt=pt, no=no)
    assert mfu_bench_torch.local_ba_work(cfg.local_ba_max_kfs, pt, o) == (
        evaluate(exprs["flops"][2], **names), evaluate(exprs["bytes_"][1], **names))
    # the fused step's: the fourth flops equal; img_b, with the searches'
    # bytes counted as the matcher rows count them in place of the third
    # bytes' distance blocks
    N, P = cfg.n_features, cfg.local_ba_max_points
    step = dict(N=N, P=P, cfg=cfg, asdnet_flops=ref_flops)
    img_b = evaluate(exprs["img_b"][0], **step)
    flops, bytes_ = mfu_bench_torch.fused_step_work(cfg)
    assert flops == evaluate(exprs["flops"][3], **step)
    assert bytes_ == img_b + roofline.matcher_bytes(N, N, 128) + roofline.matcher_bytes(P, N, 128)
    assert bytes_ < evaluate(exprs["bytes_"][2], img_b=img_b, **step)


@pytest.mark.parametrize("n,m", [(2000, 2000), (8192, 2000)])
def test_matcher_counts(n, m):
    """Bytes the masked_nn inputs read once and its three outputs written
    once, not the reference's distance matrix; FLOPs the gated-in pairs'
    dots, at most the reference's 2·N·M·d; chip_smoke.py's kernel bound
    is the larger of the same two counts over the peaks."""
    _, exprs = reference_counts()
    for d in (128, 256):
        args = (torch.zeros(n, d), torch.zeros(m, d), torch.ones(n, dtype=torch.bool),
                torch.ones(m, dtype=torch.bool), torch.zeros(n, 2), torch.zeros(m, 2),
                torch.zeros(n), None, None)
        full = chip_smoke.k1_full_args(args)
        inputs = sum(a.numel() * a.element_size() for a in full[:9])
        assert roofline.matcher_bytes(n, m, d) == inputs + n * 12
        for pairs in (0, 1234, n * m):
            assert roofline.matcher_flops(pairs, d) == 2 * d * pairs
            bound, by = chip_smoke.k1_bound_ms(full, pairs)
            t_bytes = roofline.matcher_bytes(n, m, d) / roofline.H100["bytes"]
            t_ops = roofline.matcher_flops(pairs, d) / roofline.H100["bf16"]
            assert bound == pytest.approx(max(t_bytes, t_ops) * 1e3)
            assert by == ("bytes" if t_bytes >= t_ops else "operations")
    assert roofline.matcher_flops(n * m, 128) == evaluate(exprs["flops"][0], N=n, M=m)
    assert roofline.matcher_bytes(n, m, 128) < evaluate(exprs["bytes_"][0], N=n, M=m)


def test_one_definition_of_the_peaks():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") is roofline.H100
    assert roofline.H100 == {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12}
    for script in ("chip_smoke.py", "mfu_bench_torch.py"):
        src = open(os.path.join(ROOT, script)).read()
        assert "989e12" not in src and "3.35e12" not in src and "67e12" not in src, script


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", ""])
def test_unknown_card_raises(name):
    with pytest.raises(ValueError, match="no peak rates"):
        roofline.peaks_for(name)


@pytest.mark.parametrize("peak", ["bf16", "f32"])
def test_roofline_row_and_share_limit(peak):
    p = roofline.H100
    flops, bytes_ = 1e12, 1e9
    t_sol = max(flops / p[peak], bytes_ / p["bytes"])
    row = roofline.roofline_row("x", 2 * t_sol * 1e3, flops, bytes_, p, peak)
    assert row["sol_frac"] == pytest.approx(0.5) and row["peak"] == peak
    assert row["bound"] == ("compute" if flops / p[peak] >= bytes_ / p["bytes"] else "bandwidth")
    assert row["mfu"] == pytest.approx(flops / p[peak] / (2 * t_sol))
    assert row["bw_util"] == pytest.approx(bytes_ / p["bytes"] / (2 * t_sol))
    roofline.roofline_row("x", t_sol * 1e3 / 1.04, flops, bytes_, p, peak)
    with pytest.raises(AssertionError, match="above 1.05"):
        roofline.roofline_row("x", t_sol * 1e3 / 1.06, flops, bytes_, p, peak)


def run(main_fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main_fn(argv, **kw)
    return out, buf.getvalue().splitlines()


def test_mfu_cpu_rows_have_null_shares():
    cfg = SlamConfig(**TINY)
    out, lines = run(mfu_bench_torch.main, ["--device", "cpu"], cfg=cfg,
                     match_shapes=(("match_motion_200x200", 200, 200),), ba_shape=(128, 512),
                     calls=1, windows=1)
    assert lines[0].startswith("card: none") and json.loads(lines[-1]) == out
    assert out["metric"] == "mfu_roofline" and out["device"] == "cpu" and out["peaks"] is None
    C = cfg.local_ba_max_kfs + cfg.local_ba_max_fixed
    assert [r["name"] for r in out["kernels"]] == [
        "match_motion_200x200", "asdnet_forward_200x32x32", f"local_ba_{C}c_128p_512o_15it",
        "fused_track_step"]
    assert [r["peak"] for r in out["kernels"]] == ["bf16", "bf16", "f32", "bf16"]
    for r in out["kernels"]:
        assert r["ms"] > 0 and r["gflops"] > 0 and r["mbytes"] > 0
        assert all(r[k] is None for k in ("mfu", "bw_util", "bound", "sol_ms", "sol_frac"))
    # the matcher row's FLOPs: its gated-in pairs (the same generator
    # draws: 200 positions each in a 1200 px square, a 15 px window)
    g = torch.Generator().manual_seed(0)
    torch.randn(200, 128, generator=g), torch.randn(200, 128, generator=g)
    uv_a, uv_b = torch.rand(200, 2, generator=g) * 1200.0, torch.rand(200, 2, generator=g) * 1200.0
    pairs = int((torch.cdist(uv_a, uv_b) <= 15.0).sum())
    match_row = out["kernels"][0]
    assert 0 < match_row["pairs_in"] == pairs < 200 * 200 // 100
    assert match_row["gflops"] == 2 * 128 * pairs / 1e9


def test_mfu_rows_are_the_reference_rows():
    """At the default shapes the port's row names are mfu_bench.py's."""
    src = open(os.path.join(ROOT, "mfu_bench.py")).read()
    cfg = SlamConfig()
    C = cfg.local_ba_max_kfs + cfg.local_ba_max_fixed
    ours = [label for label, _, _ in mfu_bench_torch.MATCH_SHAPES]
    ours += [f"asdnet_forward_{cfg.n_features}x32x32", "fused_track_step"]
    for name in ours:
        assert f'"{name}"' in src, name
    assert 'f"local_ba_{C}c_{Pt}p_{O}o_15it"' in src and mfu_bench_torch.BA_SHAPE == (4096, 16384)


def test_profile_stages_cpu_prints_every_stage():
    _, lines = run(profile_stages_torch.main, ["--device", "cpu"], cfg=SlamConfig(**TINY),
                   calls=1)
    out = json.loads(lines[-1])
    assert out["metric"] == "stage_ms" and out["card"] is None and lines[0].startswith("card:")
    ref = re.findall(r'bench\("([^"]+)"', open(os.path.join(ROOT, "profile_stages.py")).read())
    ref.append("h2d image")

    def shape_free(name):
        return re.sub(r"\(\d+\)", "(n)", name)

    assert [shape_free(k) for k in out["stages"]] == [shape_free(k) for k in ref]
    assert list(out["stages"]) == [l.split("  ")[0].strip() for l in lines[1:-1]]
    assert all(v > 0 for v in out["stages"].values())
