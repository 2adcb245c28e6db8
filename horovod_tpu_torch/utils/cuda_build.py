"""Build and load the port's CUDA kernels: one shared library for every
source under ``horovod_tpu_torch/csrc``.

Each ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into one library
with a plain C interface, loaded with ctypes. The library's name carries a
hash of the flags and of every ``.cu`` and ``.cuh`` file under ``csrc``, so
an edit to any kernel or shared header rebuilds it at first use. Nothing
is built when a module is imported: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
SOURCES = (CSRC / "maxmin.cu",
           CSRC / "norm.cu",
           CSRC / "flash_attention.cu",
           CSRC / "flash_attention_wgmma.cu",
           CSRC / "batch_norm.cu")
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc was not found on PATH or in /usr/local/cuda; "
                       "the CUDA kernels cannot be built")


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of the first that
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"building the CUDA kernels failed: "
                               f"{' '.join(cmd)} exited {proc.returncode}:\n"
                               f"{out}")


def source_key(csrc: Path = CSRC) -> str:
    """Hash of the flags and of every ``.cu`` and ``.cuh`` file under
    ``csrc`` (names and contents, in name order)."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in csrc.rglob("*")
                      if p.suffix in (".cu", ".cuh")):
        key.update(src.relative_to(csrc).as_posix().encode() + b"\0")
        key.update(src.read_bytes())
    return key.hexdigest()[:16]


def build() -> Path:
    """Compile every source unless a library for their current content and
    flags exists, and return the library's path. Objects and library are
    written under names of this process and the library renamed at the
    end, so ranks that build at once never load a half-written file."""
    path = BUILD_DIR / f"libhvd_kernels-{source_key()}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{path.stem}.{src.stem}.{os.getpid()}.o"
            for src in SOURCES]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(SOURCES, objs)])
    tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.so.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library (built at the first call)."""
    handle = ctypes.CDLL(str(build()))
    handle.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    handle.hvd_cuda_error_string.restype = ctypes.c_char_p
    return handle


def launch(counts: Dict[str, int], name: str, fn, *args) -> None:
    """Call a C launcher on PyTorch's current stream; raise if the launch
    was refused, else add one to ``counts[name]``."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib().hvd_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    counts[name] += 1
