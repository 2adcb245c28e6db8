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

The core's C++ unit tests (``native/unit_tests.cpp``, linked with every
source, ``core.cpp`` included) build here too, plain with the library's
flags or under ``-fsanitize=thread`` at ``-O1`` (the JAX package Makefile's
``check`` and ``check-tsan``)::

    python -m horovod_tpu_torch.utils.native_build --check [--tsan]

builds the binary into ``_build`` (once for its sources) and runs it; it
prints ``native unit tests: ALL OK`` and exits 0 when every case passes,
and a TSan build exits 66 on a reported race.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE = _PKG_DIR / "native"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = tuple(NATIVE / f"{name}.cpp" for name in (
    "socket_util", "message", "transport", "shm_transport", "compressed",
    "metrics", "tracing", "flightrec", "perfstats", "profiler", "gradstats",
    "data_plane", "timeline", "autotune", "sha256", "core"))
# The unit tests: not part of the library, nor of its key.
UNIT_TESTS = NATIVE / "unit_tests.cpp"
# -O3: the reduction loops rely on gcc's auto-vectorization;
# -fno-omit-frame-pointer: the sampling profiler walks frame pointers.
CXX_FLAGS = ("-O3", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-pthread", "-fno-omit-frame-pointer")
LD_FLAGS = ("-shared", "-pthread")
LIBS = ("-lrt", "-ldl")
# The sanitizer build: -O1 and frame pointers for accurate stacks.
TSAN_FLAGS = ("-O1", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
              "-pthread", "-fno-omit-frame-pointer", "-fsanitize=thread")
TSAN_OPTIONS = "exitcode=66 report_thread_leaks=0"


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
    ``native`` (names and contents, in name order), the unit tests'
    ``unit_tests.cpp`` left out."""
    key = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS + LIBS).encode())
    for src in sorted(p for p in native.iterdir()
                      if p.suffix in (".cpp", ".h") and
                      p.name != UNIT_TESTS.name):
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


def unit_tests_path(tsan: bool = False) -> Path:
    """Where the unit-test binary for the current sources lives once
    built."""
    key = hashlib.sha256((source_key() + " ".join(TSAN_FLAGS)).encode())
    key.update(UNIT_TESTS.read_bytes())
    return BUILD_DIR / (f"unit_tests-{key.hexdigest()[:16]}"
                        f"{'-tsan' if tsan else ''}")


def build_unit_tests(tsan: bool = False) -> Path:
    """Compile ``unit_tests.cpp`` and every source of the core (one
    ``g++`` each, all at once) and link them into one binary, unless one
    for the current sources exists; return its path."""
    path = unit_tests_path(tsan)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = TSAN_FLAGS if tsan else CXX_FLAGS
    with open(BUILD_DIR / f".{path.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        cxx = _cxx()
        srcs = (*SOURCES, UNIT_TESTS)
        objs = [BUILD_DIR / f"{path.name}.{src.stem}.{os.getpid()}.o"
                for src in srcs]
        try:
            _run_all([[cxx, *flags, "-c", "-o", str(obj), str(src)]
                      for src, obj in zip(srcs, objs)])
            tmp = BUILD_DIR / f"{path.name}.{os.getpid()}.tmp"
            link = ("-pthread", "-fsanitize=thread") if tsan \
                else ("-pthread",)
            _run_all([[cxx, *link, "-o", str(tmp), *map(str, objs),
                       *LIBS]])
            os.replace(tmp, path)
        finally:
            for obj in objs:
                if obj.exists():
                    obj.unlink()
    return path


def run_unit_tests(tsan: bool = False, timeout: float = 600
                   ) -> subprocess.CompletedProcess:
    """Build the unit tests (plain, or under TSan) and run them; the
    completed process, its output captured."""
    env = dict(os.environ)
    if tsan:
        env["TSAN_OPTIONS"] = TSAN_OPTIONS
    return subprocess.run([str(build_unit_tests(tsan))], env=env,
                          capture_output=True, text=True, timeout=timeout)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="Build the port's native core, or build and run its "
                    "C++ unit tests.")
    parser.add_argument("--check", action="store_true",
                        help="build and run the unit tests")
    parser.add_argument("--tsan", action="store_true",
                        help="with --check: under -fsanitize=thread")
    args = parser.parse_args(argv)
    if not args.check:
        print(build())
        return 0
    proc = run_unit_tests(args.tsan)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
