"""Import hygiene of the PyTorch port: no file of asdslam_torch, and not
chip_smoke.py, imports jax or the JAX package, and no kernel launch sits
inside a try whose except could fall back to another path."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "asdslam_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    assert (ROOT / "asdslam_torch" / "csrc" / "masked_nn.cu").exists()


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
