"""Build and load the port's host C++ sources (``csrc/*.cpp``) with g++.

A source exports plain C functions; `load` compiles it into a shared
library under ``csrc/build/host-<hash>/`` (ignored by git), or under a
``build_directory`` the caller names, and returns a ``ctypes.CDLL``.
The library is rebuilt when the content hash of the sources, the flags
or the build directory changes.  The compile writes a temporary file and
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
import sysconfig
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
CFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"]
LDFLAGS = ["-lpthread"]


class BuildError(RuntimeError):
    pass


def _hash(paths, cflags=CFLAGS, ldflags=LDFLAGS, build_directory=None):
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(cflags + ldflags).encode())
    if build_directory is not None:
        h.update(str(build_directory).encode())
    return h.hexdigest()[:16]


def load(name, sources, extra_cflags=None, extra_ldflags=None,
         extra_include_paths=None, build_directory=None, verbose=False,
         with_python=False):
    """``ctypes.CDLL`` of ``lib<name>.so`` built from ``sources`` (file
    names under ``csrc/``, or paths), JAX's build options in JAX's order:
    ``extra_cflags`` and ``extra_ldflags`` join the compile and link
    flags, ``extra_include_paths`` become ``-I`` flags and
    ``with_python`` adds Python's include directory (all of them enter
    the build's hash); the library lands in ``build_directory/host-<hash>``
    (None: ``csrc/build``); ``verbose`` prints the command."""
    paths = [Path(s) if os.path.isabs(s) else CSRC / s for s in sources]
    inc = [str(p) for p in (extra_include_paths or [])]
    if with_python:
        inc.append(sysconfig.get_paths()["include"])
    cflags = CFLAGS + list(extra_cflags or []) + [f"-I{p}" for p in inc]
    ldflags = LDFLAGS + list(extra_ldflags or [])
    root = BUILD_DIR if build_directory is None else Path(build_directory)
    out_dir = root / f"host-{_hash(paths, cflags, ldflags, build_directory)}"
    lib = out_dir / f"lib{name}.so"
    if not lib.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or \
            shutil.which("c++")
        if cxx is None:
            raise BuildError(f"building {name} needs g++ (or CXX)")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [cxx] + cflags + [str(p) for p in paths] + \
            ["-o", str(tmp)] + ldflags
        if verbose:
            print(" ".join(cmd), flush=True)
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"build of {name} failed:\n{r.stderr[-4000:]}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
