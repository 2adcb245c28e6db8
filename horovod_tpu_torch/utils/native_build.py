"""Build the port's native core, ``libhvdtpu_core.so``, from the C++
sources under ``horovod_tpu_torch/native``.

The counterpart of ``utils/cuda_build.py`` for the host code: each ``.cpp``
file is compiled by its own ``g++`` process, all started together, with the
flags of the reference core's Makefile, and the objects are linked into one
shared library, loaded with ctypes by :mod:`horovod_tpu_torch.basics`. The
library's name carries a hash of the flags and of every ``.cpp`` and ``.h``
file under ``native``, so an edit rebuilds it at first use. The build runs
under a file lock: the ranks of a world, and test processes, start at the
same moment, and only one of them compiles. The library is linked to a
temporary name and renamed, so its existence means it is complete. No
``make`` is needed. Nothing is built when a module is imported.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE = _PKG_DIR / "native"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = tuple(NATIVE / f"{name}.cpp" for name in (
    "socket_util", "message", "transport", "shm_transport", "compressed",
    "metrics", "tracing", "flightrec", "perfstats", "profiler", "gradstats",
    "data_plane", "timeline", "autotune", "sha256", "core"))
# -O3: the reduction loops rely on gcc's auto-vectorization;
# -fno-omit-frame-pointer: the sampling profiler walks frame pointers.
CXX_FLAGS = ("-O3", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-pthread", "-fno-omit-frame-pointer")
LD_FLAGS = ("-shared", "-pthread")
LIBS = ("-lrt", "-ldl")


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("g++ was not found on PATH; the native core "
                           "cannot be built")
    return found


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of the first that
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"building the native core failed: "
                               f"{' '.join(cmd)} exited {proc.returncode}:\n"
                               f"{out}")


def source_key(native: Path = NATIVE) -> str:
    """Hash of the flags and of every ``.cpp`` and ``.h`` file under
    ``native`` (names and contents, in name order)."""
    key = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS + LIBS).encode())
    for src in sorted(p for p in native.iterdir()
                      if p.suffix in (".cpp", ".h")):
        key.update(src.name.encode() + b"\0")
        key.update(src.read_bytes())
    return key.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    return BUILD_DIR / f"libhvdtpu_core-{source_key()}.so"


def build() -> Path:
    """Compile and link the core unless a library for the current sources
    and flags exists, and return its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():  # another process built it while we waited
            return path
        cxx = _cxx()
        objs = [BUILD_DIR / f"{path.stem}.{src.stem}.{os.getpid()}.o"
                for src in SOURCES]
        try:
            _run_all([[cxx, *CXX_FLAGS, "-c", "-o", str(obj), str(src)]
                      for src, obj in zip(SOURCES, objs)])
            tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.so.tmp"
            _run_all([[cxx, *LD_FLAGS, "-o", str(tmp), *map(str, objs),
                       *LIBS]])
            os.replace(tmp, path)
        finally:
            for obj in objs:
                if obj.exists():
                    obj.unlink()
    return path
