"""Nothing the harness runs loads JAX or the JAX package, comparing each
module's top-level name (the part before the first dot) whole, since the
port's name begins with the JAX package's; the references import nothing of
the program."""

import ast
import os
import subprocess
import sys

import cpu_route

FORBIDDEN = {"jax", "jaxlib", "flax", "asdslam_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    for d, _, files in os.walk(cpu_route.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax():
    for path in harness_files():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_whole_name_comparison():
    import run
    assert "asdslam_torch".split(".")[0] not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_references_import_nothing_of_the_program():
    worlds = [os.path.join("worlds", f) for f in os.listdir(os.path.join(cpu_route.BENCH, "worlds"))
              if f.endswith(".py")]
    for name in ["reference.py", "check.py", "roofline.py", "generator.py"] + worlds:
        got = top_level_imports(os.path.join(cpu_route.BENCH, name))
        assert "asdslam_torch" not in got, name


def test_loaded_modules_after_import():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, check, generator, probe, reference, roofline, control\n"
            "from asdslam_torch import system\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (cpu_route.BENCH, cpu_route.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "asdslam_torch" in loaded and not loaded & FORBIDDEN
