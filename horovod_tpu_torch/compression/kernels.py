"""Max-min quantization kernels: CUDA wrappers, plain versions, launch counts.

Counterpart of ``horovod_tpu/compression/pallas_kernels.py`` for B1
(``maxmin_quantize_pallas``), B2 (``maxmin_quantize_stochastic_pallas``),
B3 (``maxmin_dequantize_sum_pallas``) and B4
(``maxmin_dequantize_pallas``). The kernels are CUDA C++ for Hopper in
``horovod_tpu_torch/csrc/maxmin.cu``, built with the port's other kernels
into one shared library at first use (``utils/cuda_build.py``).

Each wrapper takes the plain PyTorch version beside it for a tensor on the
CPU, launches its kernel for a CUDA tensor, and raises for any other device:
there is no fallback. ``LAUNCHES`` counts kernel launches, so a run can show
that its path went through the kernels, and ``ROUTES`` counts the launches
of B2, B3 and B4 by the route the C entry point reports
(``hvd_maxmin_last_route``). On B2's ``packed`` route (:func:`packed_route`)
the kernel writes the codes packed as ``pack_bits`` packs them, on its
``bytes`` route one byte per code. B3 and B4 read the packed payload as it
crossed the wire, on the ``packed`` route where a bucket is a multiple of 8
codes (:func:`decode_route`), else on the ``generic`` one; 8 bits is one
byte per code, so B1's codes go through them as they are. The packing
itself (:func:`pack_bits`, :func:`unpack_bits`; the JAX package's
``compression/quantize.py:36-58``) lives here, and ``quantize`` re-exports
it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build

LAUNCHES: Dict[str, int] = {
    "maxmin_quantize": 0,
    "maxmin_quantize_stochastic": 0,
    "maxmin_dequantize": 0,
    "maxmin_dequantize_sum": 0,
}


ROUTES: Dict[str, Dict[str, int]] = {
    "maxmin_quantize_stochastic": {"packed": 0, "bytes": 0},
    "maxmin_dequantize": {"packed": 0, "generic": 0},
    "maxmin_dequantize_sum": {"packed": 0, "generic": 0}}
_ROUTE_NAMES = {1: "packed", 2: "bytes", 3: "generic"}
# The packed routes of B2 and B5 hold a bucket in registers, 8 groups of 8
# values a lane at most (csrc/bucket_groups.cuh).
PACKED_MAX_BUCKET = 2048


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


def packed_route(bucket_size: int) -> bool:
    """Whether B2 and B5 take a packed route for buckets of ``bucket_size``
    values (the rule of ``packed_groups_per_lane`` in
    ``csrc/bucket_groups.cuh``): a multiple of 8 values, at most
    ``PACKED_MAX_BUCKET``, at any address. Other buckets take the
    byte-code route."""
    return bucket_size % 8 == 0 and bucket_size <= PACKED_MAX_BUCKET


def decode_route(bucket_size: int) -> str:
    """The route of B3 and B4 for buckets of ``bucket_size`` values, by the
    bucket alone: ``packed`` (8 codes are ``bits`` whole bytes, read with
    one load) for a multiple of 8, else ``generic``."""
    return "packed" if bucket_size % 8 == 0 else "generic"


def count_route(routes: Dict[str, int], names: Dict[int, str], code: int,
                expected: str, what: str) -> None:
    """Count the route a C entry point reports; raise if it is not the one
    the wrapper allocated its output for."""
    route = names.get(code)
    if route != expected:
        raise RuntimeError(f"{what}: the library reports route {code} "
                           f"({route}), the wrapper expected {expected}")
    routes[route] += 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.lib()
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hvd_maxmin_quantize.argtypes = [ptr, i64, i64, i32, i32, ptr, ptr,
                                        ptr, ptr]
    lib.hvd_maxmin_quantize.restype = i32
    u64 = ctypes.c_uint64
    lib.hvd_maxmin_quantize_stochastic.argtypes = [ptr, i64, i64, i32, i32,
                                                   u64, u64, ptr, ptr, ptr,
                                                   ptr]
    lib.hvd_maxmin_quantize_stochastic.restype = i32
    lib.hvd_maxmin_last_route.argtypes = []
    lib.hvd_maxmin_last_route.restype = i32
    lib.hvd_maxmin_dequantize.argtypes = [ptr, i64, i64, ptr, ptr, i64, i32,
                                          i32, ptr, ptr]
    lib.hvd_maxmin_dequantize.restype = i32
    lib.hvd_maxmin_dequantize_sum.argtypes = [ptr, i32, i64, ptr, ptr, i64,
                                              i32, i32, ptr, ptr]
    lib.hvd_maxmin_dequantize_sum.restype = i32
    return lib


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> bool:
    """Validate a kernel argument; True when it lies on the CPU (the plain
    version runs), False for CUDA (the kernel runs). Raises otherwise."""
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} lies on {t.device}: the kernel runs on CUDA "
                         "and its plain version on the CPU only")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return False


def _same_device(first: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.device != first.device:
            raise ValueError(f"arguments lie on {first.device} and "
                             f"{t.device}")


# ---------------------------------------------------------------------------
# B1: max-min quantize
# ---------------------------------------------------------------------------

def bucketize(flat: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Zero-pad a flat vector and view it as ``(n_buckets, bucket_size)``
    (``quantize.py:98-103`` ``_bucketize`` in the JAX package): the padding
    counts in the last bucket's min and max."""
    n = flat.shape[0]
    n_buckets = -(-n // bucket_size)
    padded = torch.nn.functional.pad(flat, (0, n_buckets * bucket_size - n))
    return padded.view(n_buckets, bucket_size)


def _scaled(flat: torch.Tensor, bits: int, bucket_size: int):
    """Per bucket min and unit, and every value as ``(x - min) / unit'``
    (``unit' = 1`` where ``unit == 0``): what B1 and B2 share."""
    buckets = bucketize(flat, bucket_size)
    mn = buckets.amin(dim=1, keepdim=True)
    mx = buckets.amax(dim=1, keepdim=True)
    levels = (1 << bits) - 1
    # A tensor divisor: PyTorch on CUDA turns division by a Python scalar
    # into a multiply by its reciprocal, which is not the IEEE quotient.
    unit = (mx - mn) / torch.full_like(mx, levels)
    safe = torch.where(unit == 0, torch.ones_like(unit), unit)
    return (buckets - mn) / safe, mn[:, 0], unit[:, 0]


def _codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    # A NaN in a bucket makes its min and unit NaN (amin/amax pass it
    # through) and its codes 0: NaN has no defined uint8 cast.
    return q.nan_to_num_(0.0).clamp_(0, (1 << bits) - 1).to(torch.uint8)


def maxmin_quantize_plain(flat: torch.Tensor, bits: int, bucket_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of B1 (the XLA path of ``MaxMinQuantizer.compress``)."""
    scaled, mn, unit = _scaled(flat, bits, bucket_size)
    return _codes(torch.round(scaled), bits), mn, unit


def _check_quantize_args(bits: int, bucket_size: int) -> None:
    if bits not in (1, 2, 4, 8):
        raise ValueError("bits must be one of 1, 2, 4, 8")
    if bucket_size < 1:
        raise ValueError("bucket_size must be positive")


def _quantize_outputs(flat: torch.Tensor, bucket_size: int,
                      row_bytes: int):
    n_buckets = -(-flat.shape[0] // bucket_size)
    q = torch.empty((n_buckets, row_bytes), dtype=torch.uint8,
                    device=flat.device)
    mn = torch.empty((n_buckets,), dtype=torch.float32, device=flat.device)
    return q, mn, torch.empty_like(mn)


def maxmin_quantize(flat: torch.Tensor, bits: int, bucket_size: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B1: quantize a flat fp32 vector bucket-wise to ``bits`` bits.

    Returns codes ``[n_buckets, bucket_size]`` uint8 (one per byte; the
    zero padding of the last bucket is coded too), and ``min`` and ``unit``
    ``[n_buckets]`` fp32."""
    _check_quantize_args(bits, bucket_size)
    if _check(flat, "flat", torch.float32, 1):
        return maxmin_quantize_plain(flat, bits, bucket_size)
    q, mn, unit = _quantize_outputs(flat, bucket_size, bucket_size)
    if q.numel():
        with torch.cuda.device(flat.device):
            cuda_build.launch(LAUNCHES, "maxmin_quantize",
                              _lib().hvd_maxmin_quantize, flat.data_ptr(),
                              flat.shape[0], q.shape[0], bucket_size, bits,
                              q.data_ptr(), mn.data_ptr(), unit.data_ptr())
    return q, mn, unit


# ---------------------------------------------------------------------------
# B2: stochastic max-min quantize
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def philox4x32_10(counter: Tuple[torch.Tensor, ...], key: int
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Random123's ``philox4x32`` with 10 rounds) in int64
    tensor arithmetic: four counter words (int64 tensors holding 32-bit
    values) under a 64-bit ``key`` give four 32-bit words. The low 64 bits
    of a 32x32-bit product are exact under int64 wrap-around, so the high
    word is ``(p >> 32) & 0xffffffff``. The kernel B2 computes the same
    rounds in ``csrc/maxmin.cu``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        p0 = c0 * 0xD2511F53
        p1 = c2 * 0xCD9E8D57
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK32) ^ c1 ^ k0, p1 & _MASK32,
                          ((p0 >> 32) & _MASK32) ^ c3 ^ k1, p0 & _MASK32)
    return c0, c1, c2, c3


def philox_words(count: int, seed: int, offset: int,
                 device: torch.device) -> torch.Tensor:
    """Word ``i % 4`` of Philox4x32-10 at counter ``(i // 4, offset)``
    under ``seed``, for ``i`` in ``[0, count)``: int64 ``[count]``."""
    c = torch.arange(-(-count // 4), dtype=torch.int64, device=device)
    words = philox4x32_10(
        (c & _MASK32, c >> 32, torch.full_like(c, offset & _MASK32),
         torch.full_like(c, (offset >> 32) & _MASK32)), seed)
    return torch.stack(words, dim=1).view(-1)[:count]


def maxmin_quantize_stochastic_plain(flat: torch.Tensor, bits: int,
                                     bucket_size: int, seed: int,
                                     offset: int = 0
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Plain version of B2: B1 with ``floor(scaled + u)`` in place of the
    rounding, ``u = (w & 0xffffff) * 2**-24`` from the Philox word ``w`` of
    each value's index in the padded layout (:func:`philox_words`)."""
    scaled, mn, unit = _scaled(flat, bits, bucket_size)
    w = philox_words(scaled.numel(), seed, offset, flat.device)
    u = (w & 0xFFFFFF).to(torch.float32).mul_(2.0 ** -24).view(scaled.shape)
    return _codes(torch.floor(scaled + u), bits), mn, unit


def maxmin_quantize_stochastic(flat: torch.Tensor, bits: int,
                               bucket_size: int, seed: int, offset: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """B2: :func:`maxmin_quantize` with stochastic rounding, the noise of
    value ``i`` of the padded layout drawn from Philox4x32-10 at counter
    ``(i // 4, offset)`` under the 64-bit ``seed``.

    On the card's packed route (:func:`packed_route`) the codes come back
    packed, ``[n_buckets, bucket_size * bits // 8]``: each row is
    ``pack_bits`` of the bucket's codes, and the rows together are
    ``pack_bits`` of the flat codes. Elsewhere, and on the CPU, they come
    one per byte, ``[n_buckets, bucket_size]``."""
    _check_quantize_args(bits, bucket_size)
    seed, offset = seed & (2**64 - 1), offset & (2**64 - 1)
    if _check(flat, "flat", torch.float32, 1):
        return maxmin_quantize_stochastic_plain(flat, bits, bucket_size,
                                                seed, offset)
    packed = packed_route(bucket_size)
    q, mn, unit = _quantize_outputs(
        flat, bucket_size, bucket_size * bits // 8 if packed else bucket_size)
    if q.numel():
        with torch.cuda.device(flat.device):
            lib = _lib()
            cuda_build.launch(LAUNCHES, "maxmin_quantize_stochastic",
                              lib.hvd_maxmin_quantize_stochastic,
                              flat.data_ptr(), flat.shape[0], q.shape[0],
                              bucket_size, bits, seed, offset, q.data_ptr(),
                              mn.data_ptr(), unit.data_ptr())
            count_route(ROUTES["maxmin_quantize_stochastic"], _ROUTE_NAMES,
                        lib.hvd_maxmin_last_route(),
                        "packed" if packed else "bytes",
                        "maxmin_quantize_stochastic")
    return q, mn, unit


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def pack_bits(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 values (< 2**bits) along the last dim into bytes, the
    first value in the lowest bits; ``bits`` must divide 8. Zero-pads the
    last dim to a multiple of 8//bits values. Byte-equal to the JAX
    package's ``pack_bits`` on each row."""
    q = q.to(torch.uint8)
    if bits == 8:
        return q
    per = 8 // bits
    rem = q.shape[-1] % per
    if rem:
        q = F.pad(q, (0, per - rem))
    q = q.reshape(*q.shape[:-1], -1, per)
    packed = q[..., 0].clone()
    for i in range(1, per):
        packed |= q[..., i] << (i * bits)
    return packed


def unpack_bits(p: torch.Tensor, bits: int, count: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: the first ``count`` values of each
    row. The plain B3 and B4 decode with it; their kernels read the packed
    bytes themselves."""
    if bits == 8:
        return p[..., :count]
    shifts = torch.arange(0, 8, bits, dtype=torch.uint8, device=p.device)
    vals = (p.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*p.shape[:-1], -1)[..., :count]


# ---------------------------------------------------------------------------
# B4 and B3: decode the packed payload
# ---------------------------------------------------------------------------

def _check_decode(q: torch.Tensor, mn: torch.Tensor, unit: torch.Tensor,
                  bits: int, bucket_size: int, per_row: int,
                  meta_shape: Tuple[int, ...]) -> bool:
    """Validate a packed payload: rows of exactly the bytes that
    ``pack_bits`` makes of ``per_row`` buckets, and ``min``/``unit`` of
    ``meta_shape``. True when it lies on the CPU."""
    _check_quantize_args(bits, bucket_size)
    on_cpu = _check(q, "q", torch.uint8, 2)
    _check(mn, "min", torch.float32, len(meta_shape))
    _check(unit, "unit", torch.float32, len(meta_shape))
    if tuple(mn.shape) != meta_shape or tuple(unit.shape) != meta_shape:
        raise ValueError(f"min {tuple(mn.shape)} and unit "
                         f"{tuple(unit.shape)} must both be {meta_shape}")
    want = -(-per_row * bucket_size * bits // 8)
    if q.shape[1] != want:
        raise ValueError(f"q rows must hold {want} bytes (the packed codes "
                         f"of {per_row} buckets of {bucket_size} at {bits} "
                         f"bits), got {tuple(q.shape)}")
    _same_device(q, mn, unit)
    return on_cpu


def _per_row(q: torch.Tensor, mn: torch.Tensor) -> int:
    """Buckets a row of B4's ``q [rows, row_bytes]`` for ``min
    [n_buckets]``."""
    if q.dim() != 2 or mn.dim() != 1:
        raise ValueError(f"q must be [rows, row_bytes] and min [n_buckets], "
                         f"got {tuple(q.shape)} and {tuple(mn.shape)}")
    rows, n_buckets = q.shape[0], mn.shape[0]
    if rows == 0 or n_buckets % rows:
        raise ValueError(f"{n_buckets} buckets do not fill the {rows} rows "
                         f"of q")
    return n_buckets // rows


def maxmin_dequantize_plain(q: torch.Tensor, mn: torch.Tensor,
                            unit: torch.Tensor, bits: int, bucket_size: int
                            ) -> torch.Tensor:
    """Plain version of B4: the codes of the packed rows, then
    ``min + q * unit`` per bucket."""
    codes = unpack_bits(q, bits, _per_row(q, mn) * bucket_size)
    codes = codes.reshape(-1, bucket_size)
    return mn[:, None] + codes.to(torch.float32) * unit[:, None]


def _launch_decode(name: str, fn: str, q: torch.Tensor, n_buckets: int,
                   bucket_size: int, *args) -> torch.Tensor:
    """Launch B3 or B4 (C entry point ``fn``) into a new fp32
    ``[n_buckets, bucket_size]`` output and count its route."""
    out = torch.empty((n_buckets, bucket_size), dtype=torch.float32,
                      device=q.device)
    if not out.numel():
        return out
    with torch.cuda.device(q.device):
        lib = _lib()
        cuda_build.launch(LAUNCHES, name, getattr(lib, fn), q.data_ptr(),
                          *args, out.data_ptr())
        count_route(ROUTES[name], _ROUTE_NAMES, lib.hvd_maxmin_last_route(),
                    decode_route(bucket_size), name)
    return out


def maxmin_dequantize(q: torch.Tensor, mn: torch.Tensor, unit: torch.Tensor,
                      bits: int, bucket_size: int) -> torch.Tensor:
    """B4: decode a packed payload to fp32 ``[n_buckets, bucket_size]``.

    ``q`` is uint8 ``[rows, row_bytes]``: each row is ``pack_bits`` of the
    codes of ``n_buckets / rows`` buckets (code ``j`` of a row at bit
    ``j * bits``); ``min`` and ``unit`` are fp32 ``[n_buckets]``. A flat
    payload is one row; at 8 bits each code is one byte, so
    ``[n_buckets, bucket_size]`` byte codes go through as they are."""
    per_row = _per_row(q, mn)
    n_buckets = mn.shape[0]
    if _check_decode(q, mn, unit, bits, bucket_size, per_row, (n_buckets,)):
        return maxmin_dequantize_plain(q, mn, unit, bits, bucket_size)
    return _launch_decode("maxmin_dequantize", "hvd_maxmin_dequantize", q,
                          n_buckets, bucket_size, q.shape[0], q.shape[1],
                          mn.data_ptr(), unit.data_ptr(), n_buckets,
                          bucket_size, bits)


def maxmin_dequantize_sum_plain(q: torch.Tensor, mn: torch.Tensor,
                                unit: torch.Tensor, bits: int,
                                bucket_size: int) -> torch.Tensor:
    """Plain version of B3: decode each rank's row and add, rank by rank,
    in the order of the JAX package's per-rank loop (``reducers.py:68-72``).
    """
    total = torch.zeros((mn.shape[1], bucket_size), dtype=torch.float32,
                        device=q.device)
    for r in range(q.shape[0]):
        total = total + maxmin_dequantize_plain(q[r:r + 1], mn[r], unit[r],
                                                bits, bucket_size)
    return total


def maxmin_dequantize_sum(q: torch.Tensor, mn: torch.Tensor,
                          unit: torch.Tensor, bits: int, bucket_size: int
                          ) -> torch.Tensor:
    """B3: the fp32 sum over ranks of the decoded payloads,
    ``[n_buckets, bucket_size]``. ``q`` is uint8 ``[n_ranks, row_bytes]``,
    each row ``pack_bits`` of that rank's codes of ``n_buckets`` buckets;
    ``min`` and ``unit`` are fp32 ``[n_ranks, n_buckets]``."""
    if q.dim() != 2 or mn.dim() != 2 or q.shape[0] != mn.shape[0]:
        raise ValueError(f"q [n_ranks, row_bytes] and min [n_ranks, "
                         f"n_buckets] must agree, got {tuple(q.shape)} and "
                         f"{tuple(mn.shape)}")
    n_ranks, n_buckets = mn.shape
    if _check_decode(q, mn, unit, bits, bucket_size, n_buckets,
                     (n_ranks, n_buckets)):
        return maxmin_dequantize_sum_plain(q, mn, unit, bits, bucket_size)
    return _launch_decode("maxmin_dequantize_sum",
                          "hvd_maxmin_dequantize_sum", q, n_buckets,
                          bucket_size, n_ranks, q.shape[1], mn.data_ptr(),
                          unit.data_ptr(), n_buckets, bucket_size, bits)
