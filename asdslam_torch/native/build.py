"""Build the port's native host library from ``asdslam_torch/native/*.cc``.

    python -m asdslam_torch.native.build

``g++ -O3 -shared -fPIC`` over imageio.cc, mapio.cc and prefetch.cc, linked
with zlib and pthreads, into ``<repo>/build/native/``.  The library's name
carries a hash of the sources and flags, so an edited source rebuilds; it is
written to a temporary named by the process id and moved into place with
``os.replace``, so processes that build at once (test workers) never read a
half-written library.  A failed build raises with the compiler's log.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Tuple

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "native"
SOURCES = ("imageio.cc", "mapio.cc", "prefetch.cc")
# no -march=native and no contraction: the decoder's floats are numpy's, bit for bit
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    for name in SOURCES:
        h.update((HERE / name).read_bytes())
    return BUILD_DIR / f"libasdslam_native-{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """(the library's path, the compiler's log; "" when the library for
    these sources was already built).  Raises RuntimeError if g++ is missing
    or the build fails."""
    with _lock:
        out = library_path()
        if out.exists():
            return out, ""
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("native library: g++ not found on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *FLAGS, "-o", str(tmp), *(str(HERE / s) for s in SOURCES), *LIBS]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native library build failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        return out, log


if __name__ == "__main__":
    path, text = build()
    print(text or "(already built)")
    print(path)
    sys.exit(0)
