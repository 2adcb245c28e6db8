"""Norm quantization kernels: CUDA wrappers, plain versions, launch counts.

Counterpart of ``horovod_tpu/compression/pallas_kernels.py`` for B5
(``norm_quantize_pallas``) and B6 (``norm_dequantize_pallas``), which serve
``NormalizedQuantizer``. The kernels are CUDA C++ for Hopper in
``horovod_tpu_torch/csrc/norm.cu``, built with the port's other kernels
into one shared library at first use (``utils/cuda_build.py``).

Each wrapper takes the plain PyTorch version beside it for a tensor on the
CPU, launches its kernel for a CUDA tensor, and raises for any other device:
there is no fallback. ``LAUNCHES`` counts kernel launches, and ``ROUTES``
counts B5's by the route the C entry point reports
(``hvd_norm_last_route``): ``packed_search`` and ``packed_scan`` write the
codes packed as ``pack_bits`` packs them (:func:`kernels.packed_route`), the
level found by bisection on a table that :func:`searchable` accepts or by
the linear scan on any other; ``bytes`` writes one byte per code (both
count in Python: the replay of a captured step adds nothing). Whether a
table may be bisected is decided here only: by :class:`LevelTable`, which
checks it once where it is built, or by :func:`norm_quantize` for a plain
tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..utils import cuda_build
from .kernels import _check, _same_device, bucketize, count_route, \
    packed_route

MAX_LEVELS = 128  # 8 bits: 7 index bits and the sign bit

LAUNCHES: Dict[str, int] = {
    "norm_quantize": 0,
    "norm_dequantize": 0,
}


ROUTES: Dict[str, Dict[str, int]] = {
    "norm_quantize": {"packed_search": 0, "packed_scan": 0, "bytes": 0}}
_ROUTE_NAMES = {1: "packed_search", 2: "packed_scan", 3: "bytes"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


def searchable(levels) -> bool:
    """Whether B5 may find the nearest level by bisection: the table is
    finite and strictly descending. ``set_quantization_levels`` asks for a
    descending table but does not enforce it, so any other table takes the
    linear scan. Checked on the host, where the table is built."""
    table = np.asarray(levels, dtype=np.float32).reshape(-1)
    return bool(np.isfinite(table).all() and (table[1:] < table[:-1]).all())


class LevelTable:
    """A level table copied to ``device``, checked once on the host:
    ``search`` says whether B5 may find its nearest level by bisection
    (:func:`searchable`). :func:`norm_quantize` takes it in place of the
    table's tensor and then does not check the table again."""

    __slots__ = ("levels", "search")

    def __init__(self, levels, device):
        table = np.asarray(levels, dtype=np.float32).reshape(-1)
        self.search = searchable(table)
        self.levels = torch.from_numpy(table.copy()).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.lib()
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hvd_norm_quantize.argtypes = [ptr, i64, i64, i32, ptr, i32, i32, i32,
                                      i32, ptr, ptr, ptr]
    lib.hvd_norm_quantize.restype = i32
    lib.hvd_norm_last_route.argtypes = []
    lib.hvd_norm_last_route.restype = i32
    lib.hvd_norm_dequantize.argtypes = [ptr, ptr, i32, ptr, i64, i32, ptr,
                                        ptr]
    lib.hvd_norm_dequantize.restype = i32
    return lib


def _check_levels(levels: torch.Tensor) -> None:
    _check(levels, "levels", torch.float32, 1)
    if not 1 <= levels.shape[0] <= MAX_LEVELS:
        raise ValueError(f"the level table must hold 1 to {MAX_LEVELS} "
                         f"entries, got {levels.shape[0]}")


# ---------------------------------------------------------------------------
# B5: norm quantize
# ---------------------------------------------------------------------------

def nearest_level_plain(ratio: torch.Tensor, levels: torch.Tensor
                        ) -> torch.Tensor:
    """The index of the nearest level of each ``ratio`` (uint8): a running
    argmin over the table with a strict ``<``, so the first minimum wins as
    in ``jnp.argmin``; it never holds the ``[n, bucket, L]`` distance tensor
    of the JAX package's XLA path."""
    best_d = (ratio - levels[0]).abs()
    best = torch.zeros(ratio.shape, dtype=torch.uint8, device=ratio.device)
    for i in range(1, levels.shape[0]):
        d = (ratio - levels[i]).abs()
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best.masked_fill_(take, i)
    return best


def norm_quantize_plain(flat: torch.Tensor, levels: torch.Tensor,
                        bucket_size: int, use_l2: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B5, one byte per code."""
    buckets = bucketize(flat, bucket_size)
    if use_l2:
        norm = (buckets * buckets).sum(dim=1, keepdim=True).sqrt()
    else:
        norm = buckets.abs().amax(dim=1, keepdim=True)
    safe = torch.where(norm == 0, torch.ones_like(norm), norm)
    best = nearest_level_plain(buckets.abs() / safe, levels)
    q = (best << 1) | (buckets < 0).to(torch.uint8)
    return q, norm[:, 0]


def norm_quantize(flat: torch.Tensor,
                  levels: Union[torch.Tensor, LevelTable], bucket_size: int,
                  use_l2: bool, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5: quantize a flat fp32 vector bucket-wise against the descending
    level table ``levels`` (fp32, 1 to ``2**(bits - 1)`` entries, at most
    128, on the same device; a tensor, or a :class:`LevelTable`, whose
    check of the table's order is then used).

    Returns the codes, ``(idx << 1) | sign`` (the zero padding of the last
    bucket is coded too), and the norm of each bucket, ``[n_buckets]``
    fp32: ``sqrt(sum x^2)`` when ``use_l2``, else ``max |x|``. On the card's
    packed routes (:func:`kernels.packed_route`) the codes come back packed
    at ``bits`` bits, ``[n_buckets, bucket_size * bits // 8]``, each row
    ``pack_bits`` of the bucket's codes; elsewhere, and on the CPU, one per
    byte, ``[n_buckets, bucket_size]`` (at 8 bits the two are the same).
    On the card a plain tensor's table is checked here, which copies it to
    the host."""
    search = None
    if isinstance(levels, LevelTable):
        levels, search = levels.levels, levels.search
    if bucket_size < 1:
        raise ValueError("bucket_size must be positive")
    if bits not in (1, 2, 4, 8):
        raise ValueError("bits must be one of 1, 2, 4, 8")
    on_cpu = _check(flat, "flat", torch.float32, 1)
    _check_levels(levels)
    if levels.shape[0] > 1 << (bits - 1):
        raise ValueError(f"a table of {levels.shape[0]} levels does not fit "
                         f"codes of {bits} bits")
    _same_device(flat, levels)
    if on_cpu:
        return norm_quantize_plain(flat, levels, bucket_size, use_l2)
    if search is None:
        search = searchable(levels.cpu().numpy())
    n = flat.shape[0]
    n_buckets = -(-n // bucket_size)
    packed = packed_route(bucket_size)
    route = ("packed_search" if search else "packed_scan") if packed \
        else "bytes"
    q = torch.empty(
        (n_buckets, bucket_size * bits // 8 if packed else bucket_size),
        dtype=torch.uint8, device=flat.device)
    norm = torch.empty((n_buckets,), dtype=torch.float32, device=flat.device)
    if n_buckets:
        with torch.cuda.device(flat.device):
            lib = _lib()
            cuda_build.launch(LAUNCHES, "norm_quantize",
                              lib.hvd_norm_quantize, flat.data_ptr(), n,
                              n_buckets, bucket_size, levels.data_ptr(),
                              levels.shape[0], int(use_l2), bits,
                              int(search), q.data_ptr(), norm.data_ptr())
            count_route(ROUTES["norm_quantize"], _ROUTE_NAMES,
                        lib.hvd_norm_last_route(), route, "norm_quantize")
    return q, norm


# ---------------------------------------------------------------------------
# B6: norm dequantize
# ---------------------------------------------------------------------------

def norm_dequantize_plain(q: torch.Tensor, levels: torch.Tensor,
                          norm: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: ``(1 - 2 sign) * level[clip(idx)]``, then times
    the bucket's norm (the order of ``quantize.py:337-342``)."""
    sign = 1.0 - 2.0 * (q & 1).to(torch.float32)
    idx = (q >> 1).to(torch.int64).clamp_(max=levels.shape[0] - 1)
    return (sign * levels[idx]) * norm[:, None]


def norm_dequantize(q: torch.Tensor, levels: torch.Tensor,
                    norm: torch.Tensor) -> torch.Tensor:
    """B6: codes ``[n_buckets, bucket]`` uint8 with the level table and the
    per-bucket ``norm`` ``[n_buckets]`` -> fp32 ``[n_buckets, bucket]``. An
    index past the table decodes at its last level."""
    if q.dim() != 2:
        raise ValueError(f"q must be [n_buckets, bucket], got "
                         f"{tuple(q.shape)}")
    n_buckets, bucket = q.shape
    on_cpu = _check(q, "q", torch.uint8, 2)
    _check_levels(levels)
    _check(norm, "norm", torch.float32, 1)
    if norm.shape[0] != n_buckets:
        raise ValueError(f"norm {tuple(norm.shape)} must be ({n_buckets},)")
    _same_device(q, levels, norm)
    if on_cpu:
        return norm_dequantize_plain(q, levels, norm)
    out = torch.empty((n_buckets, bucket), dtype=torch.float32,
                      device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            cuda_build.launch(LAUNCHES, "norm_dequantize",
                              _lib().hvd_norm_dequantize, q.data_ptr(),
                              levels.data_ptr(), levels.shape[0],
                              norm.data_ptr(), n_buckets, bucket,
                              out.data_ptr())
    return out
