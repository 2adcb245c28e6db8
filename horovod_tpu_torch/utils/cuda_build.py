"""Build and load the port's CUDA kernels: one shared library for every
source under ``horovod_tpu_torch/csrc``.

One ``nvcc`` call compiles every ``.cu`` file into one library with a plain
C interface, loaded with ctypes. The library's name carries a hash of every
source and the flags, so an edit to any kernel rebuilds it at first use.
Nothing is built when a module is imported: the CPU tests import every
module on machines without ``nvcc``.
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
SOURCES = (_PKG_DIR / "csrc" / "maxmin.cu",
           _PKG_DIR / "csrc" / "flash_attention.cu")
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


def build() -> Path:
    """Compile every source unless a library for their current content and
    flags exists, and return the library's path. It is written under a
    temporary name and renamed, so ranks that build at once never load a
    half-written file."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        key.update(src.read_bytes())
    path = BUILD_DIR / f"libhvd_kernels-{key.hexdigest()[:16]}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.so.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the CUDA kernels failed: "
                           f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
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
