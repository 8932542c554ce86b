"""Build and load the port's host C++ sources (``csrc/*.cpp``) with g++.

A source exports plain C functions; `load` compiles it into a shared
library under ``csrc/build/host-<hash>/`` (ignored by git) and returns a
``ctypes.CDLL``.  The library is rebuilt when the content hash of the
sources or the flags changes.  The compile writes a temporary file and
renames it into place, so processes that build the same library at once
(a fleet's replicas starting together) never load a half-written one.
The CUDA kernels are built apart, by ``kernels/_build.py`` with nvcc;
these sources need no CUDA, so the CPU tests build them too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
CFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"]
LDFLAGS = ["-lpthread"]


class BuildError(RuntimeError):
    pass


def _hash(paths):
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CFLAGS + LDFLAGS).encode())
    return h.hexdigest()[:16]


def load(name, sources):
    """``ctypes.CDLL`` of ``lib<name>.so`` built from ``sources`` (file
    names under ``csrc/``, or paths)."""
    paths = [Path(s) if os.path.isabs(s) else CSRC / s for s in sources]
    out_dir = BUILD_DIR / f"host-{_hash(paths)}"
    lib = out_dir / f"lib{name}.so"
    if not lib.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or \
            shutil.which("c++")
        if cxx is None:
            raise BuildError(f"building {name} needs g++ (or CXX)")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [cxx] + CFLAGS + [str(p) for p in paths] + \
            ["-o", str(tmp)] + LDFLAGS
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"build of {name} failed:\n{r.stderr[-4000:]}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
