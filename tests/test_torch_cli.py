"""The port's command-line entry points on the CPU: run_slam_torch.py,
train_vocab_torch.py, display_map_torch.py and bench_torch.py against their
JAX twins (run_slam.py, train_vocab.py, display_map.py), through each
script's main(argv) in-process, and once as a real command.

Bars: the files the two packages write from the same inputs are byte for
byte equal (the .map and the result dumps after a localization run on the
same map, display_map's JSON line and PLY); train_vocab_torch's .npz with
the JAX draws replayed has the same words for every training descriptor
and centroids / idf within 1e-6, the bar of tests/test_torch_loop.py's
vocabulary test (the port's Lloyd sums are exact, the reference's f32 sums
in index order).

Run as a script it prints the JAX package's results on chip_smoke.py's
phase 8 (the KITTI-layout directory of 30 corridor frames at 1241x376, the
EuRoC proxy's first 40 frames at 752x480; CPU, ~6 min), the yardsticks of
its bars:

    python tests/test_torch_cli.py --reference-phase8
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402  (the scripts at the repository's root)
from chip_smoke import last_json, write_kitti_dir  # noqa: E402
import display_map  # noqa: E402
import display_map_torch  # noqa: E402
import eval_euroc_proxy_torch  # noqa: E402
import eval_kitti_proxy_torch  # noqa: E402
import mfu_bench_torch  # noqa: E402
import profile_stages_torch  # noqa: E402
import run_slam  # noqa: E402
import run_kitti_suite_torch  # noqa: E402
import run_slam_torch  # noqa: E402
import train_vocab  # noqa: E402
import train_vocab_torch  # noqa: E402
from asdslam_torch.io import datasets  # noqa: E402
from asdslam_torch.loop import vocab as tvocab  # noqa: E402
from asdslam_torch.mapping import persistence  # noqa: E402


def jax_script(*args, timeout=1800):
    """A script of the JAX package run on the CPU; returns its output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable] + list(args), cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


SCRIPTS = {"run_slam_torch": run_slam_torch, "train_vocab_torch": train_vocab_torch,
           "eval_euroc_proxy_torch": eval_euroc_proxy_torch,
           "display_map_torch": display_map_torch, "bench_torch": bench_torch,
           "eval_kitti_proxy_torch": eval_kitti_proxy_torch,
           "run_kitti_suite_torch": run_kitti_suite_torch, "mfu_bench_torch": mfu_bench_torch,
           "profile_stages_torch": profile_stages_torch}
RESULT_FILES = ("traj", "track", "posi", "kps", "desc")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def in_process(main_fn, argv):
    """main_fn(argv) and its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main_fn(argv)
    return ret, buf.getvalue()


def reference_main(main_fn, argv, monkeypatch):
    """A JAX twin's main(), which reads sys.argv, and its standard output."""
    monkeypatch.setattr(sys, "argv", ["script"] + list(argv))
    return in_process(lambda _: main_fn(), None)[1]


def read_tree(root):
    """{name: bytes} of the files directly in ``root``."""
    out = {}
    for n in sorted(os.listdir(root)):
        if os.path.isfile(os.path.join(root, n)):
            with open(os.path.join(root, n), "rb") as f:
                out[n] = f.read()
    return out


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The command itself: python3 run_slam_torch.py --dataset synthetic
    --device cpu --n_frames 20, with every output it can write."""
    d = tmp_path_factory.mktemp("run")
    paths = {k: str(d / v) for k, v in (("map", "run.map"), ("voc", "voc.npz"),
                                        ("res", "result"), ("viz", "viz"), ("traj", "traj.txt"))}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_slam_torch.py"), "--dataset", "synthetic",
         "--device", "cpu", "--n_frames", "20", "--save_map", paths["map"], "--save_voc",
         paths["voc"], "--save_result_dir", paths["res"], "--viz_dir", paths["viz"],
         "--viz_every", "5", "--output_addr", paths["traj"], "--profile"],
        cwd=str(d), env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return paths, out.stdout


def test_command_line_run(port_run):
    paths, stdout = port_run
    line = last_json(stdout)
    assert line["frames"] == 20 and line["tracked"] >= 10 and line["keyframes"] >= 3, line
    assert line["trajectory"] == paths["traj"]
    assert stdout.startswith("frame 0/20 tracked=")
    assert "fused_track" in stdout                      # --profile's spans
    assert len(open(paths["traj"]).readlines()) == line["keyframes"]
    assert all(os.path.getsize(os.path.join(paths["res"], n + ".txt")) for n in RESULT_FILES)
    for topic, count in (("camera/frame", 4), ("map/topdown", 4), ("map/points", 3),
                         ("map/trajectory", 3)):
        assert len(os.listdir(os.path.join(paths["viz"], topic))) == count, topic
    assert tvocab.load_vocab(paths["voc"], device="cpu").n_words == 10 ** 4
    data = persistence.load_visual_map(paths["map"])
    assert len(data.frames) == line["keyframes"]


def test_localization_on_saved_map_and_vocabulary(port_run):
    """--save_map -> --map_addr --localization, --save_voc -> --voc_addr:
    no keyframe added, the frames relocalized and tracked."""
    paths, stdout = port_run
    n_kf = last_json(stdout)["keyframes"]
    system, text = in_process(run_slam_torch.main, [
        "--dataset", "synthetic", "--device", "cpu", "--n_frames", "20", "--max_frame",
        "8", "--localization", "--map_addr", paths["map"], "--voc_addr", paths["voc"],
        "--output_addr", os.path.join(os.path.dirname(paths["map"]), "loc.txt")])
    line = last_json(text)
    assert line["keyframes"] == n_kf and line["tracked"] >= 4, line
    voc = tvocab.load_vocab(paths["voc"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(system.loop_closer.vocab.levels, voc.levels))


def test_same_map_same_files_as_reference(port_run, tmp_path, monkeypatch):
    """Both packages' run_slam on one saved map in localization mode: the
    .map each saves, its result dump and its keyframe trajectory are byte
    for byte equal."""
    paths, _ = port_run
    n_kf = len(persistence.load_visual_map(paths["map"]).frames)
    outs = []
    for name, call in (("jax", lambda a: reference_main(run_slam.main, a, monkeypatch)),
                       ("torch", lambda a: in_process(run_slam_torch.main, a)[1])):
        d = tmp_path / name
        d.mkdir()
        argv = ["--dataset", "synthetic", "--n_frames", str(n_kf), "--localization",
                "--map_addr", paths["map"], "--save_map", str(d / "again.map"),
                "--save_result_dir", str(d / "result"), "--output_addr", str(d / "traj.txt")]
        text = call(argv + (["--device", "cpu"] if name == "torch" else []))
        outs.append((last_json(text), read_tree(d), read_tree(d / "result")))
    (jline, jfiles, jres), (tline, tfiles, tres) = outs
    assert tline["keyframes"] == jline["keyframes"] == n_kf
    assert jfiles.keys() == tfiles.keys() and jres.keys() == tres.keys()
    for name in ("again.map", "traj.txt"):
        assert tfiles[name] == jfiles[name], name
    for name in jres:
        assert tres[name] == jres[name], name


def test_mesh_global_ba_command(tmp_path):
    """run_slam_torch.py --n_devices 2 --device cpu runs, and the global BA
    of its System's loop closer goes over a mesh of two shards."""
    system, text = in_process(run_slam_torch.main, [
        "--dataset", "synthetic", "--device", "cpu", "--n_frames", "12", "--n_devices", "2",
        "--output_addr", str(tmp_path / "traj.txt")])
    line = last_json(text)
    assert line["frames"] == 12 and line["tracked"] >= 6 and line["keyframes"] >= 3, line
    assert system.cfg.n_devices == 2 and system.loop_closer.cfg.n_devices == 2
    n = system.store.n_kf
    pre = system.store.kf_pose[:n].copy()
    system.loop_closer._global_ba()
    assert system.tracer.spans["gba_mesh"].count == 1
    assert np.isfinite(system.store.kf_pose[:n]).all()
    assert not np.array_equal(pre, system.store.kf_pose[:n])


def test_kitti_layout_directory(tmp_path):
    """--dataset kitti over PNGs and a camera file the test writes."""
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.io import synthetic

    cfg = SlamConfig(image_width=320, image_height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, _ = synthetic.render_sequence(K, 8, 240, 320, step=0.25, turn=0.004, device="cpu")
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).numpy() for f in frames]
    seq, cam = write_kitti_dir(str(tmp_path), frames_u8, cfg)
    kitti = datasets.KittiSequence(seq)
    assert len(kitti) == 8 and kitti[7][0] == pytest.approx(0.7)
    np.testing.assert_array_equal(kitti[3][1], frames_u8[3].astype(np.float32) / 255.0)
    system, text = in_process(run_slam_torch.main, [
        "--dataset", "kitti", "--seq_dir", seq, "--camera_config", cam, "--device", "cpu",
        "--feature_count", "600", "--feature_level", "4", "--no_loop_closing",
        "--output_addr", str(tmp_path / "traj.txt")])
    line = last_json(text)
    assert line["frames"] == 8 and line["keyframes"] >= 2 and line["tracked"] >= 4, line
    assert system.cfg.fx == 260.0 and not system.cfg.has_distortion


def test_train_vocab_matches_reference(port_run, tmp_path, monkeypatch):
    """train_vocab_torch.py and train_vocab.py on one map, the JAX draws
    replayed: the same words for every training descriptor, centroids and
    idf within 1e-6."""
    import jax
    from asdslam_tpu.loop import vocab as jvocab
    from test_torch_loop import jax_rand_idx

    paths, _ = port_run
    argv = ["--map_addr", paths["map"], "--branching", "6", "--depth", "3", "--seed", "5"]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    reference_main(train_vocab.main, argv + ["--out", jpath], monkeypatch)
    monkeypatch.setattr(tvocab, "draw_rand_idx", lambda gen, n, b, d: jax_rand_idx(
        jax.random.PRNGKey(5), n, b, d))
    in_process(train_vocab_torch.main, argv + ["--out", tpath, "--device", "cpu"])
    j, t = jvocab.load_vocab(jpath), tvocab.load_vocab(tpath, device="cpu")
    assert (t.branching, t.depth, len(t.levels)) == (j.branching, j.depth, len(j.levels))
    for a, b in zip(t.levels, j.levels):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(t.idf.numpy(), np.asarray(j.idf), atol=1e-6)
    d = train_vocab_torch.collect_descriptors_from_map(paths["map"])
    np.testing.assert_array_equal(d, train_vocab.collect_descriptors_from_map(paths["map"]))
    d = d[np.linalg.norm(d, axis=1) > 1e-6]
    np.testing.assert_array_equal(tvocab.transform(t, torch.from_numpy(d)).numpy(),
                                  np.asarray(jvocab.transform(j, d)))


def test_display_map_matches_reference(port_run, tmp_path, monkeypatch):
    paths, _ = port_run
    jply, tply = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    jtext = reference_main(display_map.main, [paths["map"], "--per_frame", "--ply", jply],
                           monkeypatch)
    summary, ttext = in_process(display_map_torch.main, [paths["map"], "--per_frame", "--ply",
                                                         tply, "--device", "cpu"])
    assert ttext.replace(tply, jply) == jtext
    assert summary == last_json(jtext) and summary["observations"] > 0
    assert open(tply, "rb").read() == open(jply, "rb").read()


def test_bench_measure_tiny():
    """bench_torch's measurement at a tiny configuration on the CPU: bench.py's
    keys and none of its artifact keys (TPU-era files are not read)."""
    from asdslam_torch.config import SlamConfig

    cfg = SlamConfig(image_width=160, image_height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                     n_features=200, n_levels=3, local_ba_max_points=256,
                     local_ba_max_obs=1024)
    out = bench_torch.measure(cfg, None, "cpu", n_timed=2, reps=1, ba_points=128, ba_obs=512)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "frontend_fps",
                        "local_ba_ms", "use_pallas_match", "baseline_note"}
    assert out["value"] > 0 and out["frontend_fps"] > 0 and out["local_ba_ms"] > 0
    assert bench_torch.device_names(torch.device("cpu")) == ("cpu", None)
    assert "e2e" not in open(bench_torch.__file__).read()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_cuda_without_card_exits(name, monkeypatch, tmp_path):
    """--device cuda (the default) with no card: a non-zero exit with a
    message, never a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train_vocab_torch": ["--map_addr", "none.map", "--out", str(tmp_path / "v.npz")],
            "display_map_torch": ["none.map"]}.get(name, [])
    with pytest.raises(SystemExit) as e:
        in_process(SCRIPTS[name].main, argv)
    assert "no CUDA device" in str(e.value.code)
    assert not os.listdir(tmp_path)


def test_kitti_proxy_reads_inside_the_repository(tmp_path, monkeypatch):
    """--dataset kitti_proxy reads its ground truth under the repository's
    reference/ and nowhere around the checkout: with the file absent there,
    the run exits with a message naming that path."""
    from asdslam_torch.io import kitti_proxy

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in (kitti_proxy.gt_path("03"), kitti_proxy.camera_config_path("03")):
        assert os.path.abspath(path).startswith(os.path.join(repo, "reference") + os.sep)
    monkeypatch.setattr(kitti_proxy, "GT_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        in_process(run_slam_torch.main, ["--dataset", "kitti_proxy", "--device", "cpu"])
    assert "not found" in str(e.value.code) and str(tmp_path) in str(e.value.code)


# --------------------------------------------------------------------------- #
# The yardsticks of chip_smoke.py's phase 8
# --------------------------------------------------------------------------- #
def reference_phase8():
    """The JAX package's scripts on phase 8's inputs, on the CPU: run_slam.py
    over the KITTI-layout directory (8a), again in localization mode over its
    first 20 frames (8c), display_map.py on its map (8d), and
    eval_euroc_proxy.py over 40 frames (8e)."""
    import tempfile
    import time
    import torch
    import chip_smoke
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.io import synthetic

    cfg = SlamConfig()
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, _ = synthetic.render_sequence(K, chip_smoke.N_ENTRY, cfg.image_height,
                                          cfg.image_width, step=chip_smoke.STEP_M,
                                          turn=chip_smoke.TURN, device="cpu")
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).numpy() for f in frames]
    tmp = tempfile.mkdtemp()
    seq, cam = chip_smoke.write_kitti_dir(tmp, frames_u8, cfg)
    mp = os.path.join(tmp, "run.map")
    kitti = ["run_slam.py", "--dataset", "kitti", "--seq_dir", seq, "--camera_config", cam,
             "--asdnet_weights", os.path.join(ROOT, "asdnet_weights.pkl")]
    t0 = time.time()
    line = last_json(jax_script(*kitti, "--save_map", mp,
                                "--output_addr", os.path.join(tmp, "traj.txt")))
    print(f"8a JAX run_slam.py, CPU, {chip_smoke.N_ENTRY} frames at {cfg.image_width}x"
          f"{cfg.image_height}: {line}, {time.time() - t0:.0f} s", flush=True)
    t0 = time.time()
    line = last_json(jax_script(*kitti, "--localization", "--map_addr", mp, "--max_frame",
                                str(chip_smoke.N_ENTRY_LOC),
                                "--output_addr", os.path.join(tmp, "loc.txt")))
    print(f"8c JAX run_slam.py --localization, CPU: {line}, {time.time() - t0:.0f} s",
          flush=True)
    print(f"8d JAX display_map.py, CPU: {last_json(jax_script('display_map.py', mp))}",
          flush=True)
    t0 = time.time()
    line = last_json(jax_script("eval_euroc_proxy.py", "--frames", str(chip_smoke.N_EUROC)))
    line.pop("drift", None)
    print(f"8e JAX eval_euroc_proxy.py --frames {chip_smoke.N_EUROC}, CPU: {line}, "
          f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--reference-phase8"]:
        sys.exit(__doc__)
    reference_phase8()
