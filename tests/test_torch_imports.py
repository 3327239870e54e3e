"""Import hygiene of the PyTorch port: no file of asdslam_torch, no entry
point of the port (the *_torch.py scripts) and not chip_smoke.py imports jax
or the JAX package, no kernel launch sits inside a try whose except could
fall back to another path, and every script takes its device from
``require_device``, which refuses a missing card instead of falling back to
the CPU."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port's entry points, twins of the JAX package's scripts
SCRIPTS = ("run_slam_torch.py", "train_vocab_torch.py", "eval_euroc_proxy_torch.py",
           "display_map_torch.py", "bench_torch.py", "train_asdnet_torch.py",
           "eval_kitti_proxy_torch.py", "run_kitti_suite_torch.py", "mfu_bench_torch.py",
           "profile_stages_torch.py")
# the port's measurement scripts that have no JAX twin (on the card only)
CARD_SCRIPTS = ("train_determinism_torch.py",)
FILES = (sorted((ROOT / "asdslam_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + [ROOT / s for s in SCRIPTS + CARD_SCRIPTS])
FORBIDDEN = ("jax", "jaxlib", "asdslam_tpu")
# calls that launch a hand-written kernel, directly or one level up
LAUNCHES = ("masked_nn_launch", "masked_nn", "search_projection", "fuse_pairs")
# every module of the port, slice by slice
MODULES = (
    "ops/masked_nn.py", "ops/match.py", "backend/ba.py", "estimators/linalg.py",
    "frontend/track_step.py", "frontend/extractor.py", "models/asdnet.py",
    # the synchronous System slice
    "geometry/triangulation.py", "estimators/twoview.py", "estimators/pnp.py",
    "mapping/map_store.py", "backend/mapping_kernels.py", "backend/local_mapping.py",
    "frontend/tracking.py", "utils/tracing.py", "utils/evaluate.py",
    "models/patch_descriptor.py", "system.py",
    # the default configuration: loop closure and its vocabulary
    "geometry/sim3.py", "estimators/sim3_horn.py", "loop/vocab.py", "loop/keyframe_db.py",
    "backend/pose_graph.py", "backend/global_ba.py", "loop/loop_closing.py",
    # localization mode, persistence and the radtan lens
    "geometry/camera.py", "geometry/camera_models.py", "io/synthetic.py", "io/datasets.py",
    "io/results.py", "mapping/persistence.py",
    # the entry points: the proxy renderers and the visualization sink
    "io/kitti_proxy.py", "io/euroc_proxy.py", "viz.py",
    # training
    "models/train.py", "models/proxy_pairs.py",
    # ORB, the assignment engines and the native host library
    "ops/orb.py", "ops/patches.py", "ops/assignment.py", "native/build.py", "native/loader.py",
    # multi-device: the mesh, the distributed BA, the batched tracking step
    "parallel/dist.py", "parallel/multi_seq.py",
    # the measurement twins' peak rates and roofline rows
    "utils/roofline.py",
    # the CUDA-graph capture of the hot paths (the reference's jax.jit)
    "utils/graphs.py",
)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def _call_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Name):
                yield f.id
            elif isinstance(f, ast.Attribute):
                yield f.attr


def test_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in MODULES:
        assert f"asdslam_torch/{module}" in names, module
    assert "chip_smoke.py" in names
    for script in SCRIPTS:
        assert script in names, script
    assert (ROOT / "asdslam_torch" / "csrc" / "masked_nn.cu").exists()
    for source in ("imageio.cc", "mapio.cc", "prefetch.cc"):
        assert (ROOT / "asdslam_torch" / "native" / source).exists(), source


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_fallback(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(name, line) for name, line in _imported_roots(tree) if name in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.handlers:
            guarded = set()
            for stmt in node.body:
                guarded.update(_call_names(stmt))
            hit = guarded.intersection(LAUNCHES)
            assert not hit, f"{path.name}:{node.lineno}: kernel launch {hit} inside try/except"


def test_modules_import_without_jax():
    """Every module of the port imports in a fresh interpreter in which
    ``jax`` and the JAX package cannot be imported at all."""
    import subprocess
    import sys
    names = ["asdslam_torch." + m[:-3].replace("/", ".") for m in MODULES]
    names += [s[:-3] for s in SCRIPTS + CARD_SCRIPTS]
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, fullname, path=None, target=None):\n"
        "        if fullname.split('.')[0] in ('jax', 'jaxlib', 'asdslam_tpu'):\n"
        "            raise ImportError('blocked: ' + fullname)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'asdslam_tpu') for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_take_the_device_from_require_device(script):
    """Each entry point has ``--device`` (default "cuda") and passes it to
    ``require_device``; none asks torch whether a card exists and picks a
    device of its own."""
    src = (ROOT / script).read_text()
    calls = set(_call_names(ast.parse(src)))
    assert "require_device" in calls and "is_available" not in calls, script
    assert 'p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")' in src
