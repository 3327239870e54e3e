"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C launch function.  At first use it
is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``<repo>/build/kernels/`` and loaded with ``ctypes``; the library's name
carries a hash of the source and flags, so an edited source rebuilds.  Only
the sources in the checkout are used.  The first load of any source builds
every source of ``SOURCES`` that has no current library, all in one
parallel pass.  Building and loading hold one lock, so two threads at first
use build once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("masked_nn", "stamp", "pose_lm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # held by build and load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together.  Returns each compiled source's
    compiler log (``-Xptxas -v``: registers, shared memory, spills); raises
    if any build fails."""
    with _lock:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed
    (with every other source of ``SOURCES`` that needs it)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build(SOURCES if name in SOURCES else (name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
