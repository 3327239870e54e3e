"""Import hygiene of the PyTorch port: no file of asdslam_torch, and not
chip_smoke.py, imports jax or the JAX package, and no kernel launch sits
inside a try whose except could fall back to another path."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "asdslam_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "asdslam_tpu")
# calls that launch a hand-written kernel
LAUNCHES = ("masked_nn_launch", "masked_nn")


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
    assert "asdslam_torch/ops/masked_nn.py" in names
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
