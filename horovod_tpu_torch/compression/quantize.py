"""Bucketed lossy gradient quantizers and top-k sparsification
(counterpart of ``horovod_tpu/compression/quantize.py``:
``pack_bits``/``unpack_bits`` :36-58, defined in
:mod:`horovod_tpu_torch.compression.kernels` and re-exported here,
``QuantContext`` :110-117,
``MaxMinQuantizer`` :120-207, the level tables :210-236,
``NormalizedQuantizer`` :239-343, ``TopKCompressor`` :346-378 and
``compressed_size_bytes`` :381-384).

Reference: the IST-DASLab fork's ``CPUMaxMinQuantizer``
(``compressor.h:168``), ``CPUNormalizedQuantizer`` (``compressor.h:219``)
and ``GPUTopKCompressor``, default bucket size 512 (``compressor.h:11``).
On the card the max-min quantizer runs kernel B1 (B2 when stochastic) and
decodes with B4 (:mod:`horovod_tpu_torch.compression.kernels`); the
normalized quantizer runs B5 and decodes with B6
(:mod:`horovod_tpu_torch.compression.norm_kernels`). On their packed routes
B2 and B5 write the payload's packed codes themselves (:func:`_payload`);
B1's codes, and those of the byte-code routes and of the CPU, are packed by
:func:`pack_bits` in plain PyTorch, as they are by plain jnp in the JAX
package. B4 (and B3 in the reducers) reads the packed codes as they are;
only B6's codes go through :func:`unpack_bits` first.

Every quantizer takes ``key`` in ``compress``: an ``int`` seed, a CPU
``torch.Generator`` (one seed is drawn from it) or None (seed 0, as the JAX
package's ``_seed_from_key(None)``). Only the stochastic max-min quantizer
uses it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels, norm_kernels
from .kernels import pack_bits, unpack_bits

DEFAULT_BUCKET_SIZE = 512  # reference: compressor.h:11


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantContext:
    """Static metadata needed to invert a quantized payload."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    count: int
    bits: int
    bucket_size: int


Key = Union[None, int, torch.Generator]


def seed_from_key(key: Key) -> int:
    """The 64-bit seed of a ``key``: 0 for None, an ``int`` as it is (modulo
    2**64), or one draw from a CPU ``torch.Generator``."""
    if key is None:
        return 0
    if isinstance(key, torch.Generator):
        if key.device.type != "cpu":
            raise ValueError(f"a key generator must lie on the CPU, not "
                             f"{key.device}")
        return int(torch.randint(2**63 - 1, (), generator=key))
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return int(key) & (2**64 - 1)
    raise TypeError(f"key must be None, an int or a torch.Generator, got "
                    f"{type(key).__name__}")


def fold_in(key: Key, data: int) -> int:
    """A seed derived from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``): the first two words of Philox4x32-10 at counter
    ``(data, 0, 0, 0)`` under the key's seed, low word first."""
    c = torch.tensor([data & 0xFFFFFFFF], dtype=torch.int64)
    zero = torch.zeros_like(c)
    w = kernels.philox4x32_10((c, zero, zero, zero), seed_from_key(key))
    return int(w[0]) | (int(w[1]) << 32)


def _payload(q: torch.Tensor, bits: int, bucket_size: int,
             *lead: int) -> torch.Tensor:
    """The packed codes of a payload, shaped ``(*lead, -1)``, from the
    codes ``q [n_buckets, .]`` of a quantize kernel: packed by the kernel
    (``q.shape[1] < bucket_size``; a bucket is then whole bytes, so the flat
    and the per-row packing are the same bytes), or one byte per code,
    packed here."""
    if q.shape[1] != bucket_size:
        return q.view(*lead, -1)
    return pack_bits(q.view(*lead, -1), bits)


def _padded_rows(rows: torch.Tensor, padded: int) -> torch.Tensor:
    """``rows [n, m]`` in fp32, zero-padded to ``[n, padded]`` and
    flattened."""
    rows = rows.to(torch.float32)
    if padded != rows.shape[1]:
        rows = F.pad(rows, (0, padded - rows.shape[1]))
    return rows.reshape(-1).contiguous()


class _Keyed:
    """Compressors of equal configuration are equal, so the optimizer fuses
    the leaves of equal compressors into one group."""

    def _key(self):
        raise NotImplementedError

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return type(other) is type(self) and other._key() == self._key()


class _Bucketed(_Keyed):
    """What the bucket-wise quantizers share: ``bits`` and
    ``bucket_size``."""
    bits: int
    bucket_size: int

    def _padded(self, count: int) -> int:
        return -(-count // self.bucket_size) * self.bucket_size

    def context(self, shape, dtype: torch.dtype) -> QuantContext:
        """The context of a tensor of ``shape`` and ``dtype``, without
        compressing one."""
        return QuantContext(shape=tuple(shape), dtype=dtype,
                            count=math.prod(shape), bits=self.bits,
                            bucket_size=self.bucket_size)


class MaxMinQuantizer(_Bucketed):
    """Bucket-wise linear quantization to ``bits`` bits
    (reference: ``CPUMaxMinQuantizer``, compressor.h:168)::

        unit = (max - min) / (2**bits - 1)
        q    = round_half_even((x - min) / unit)   (stochastic: floor(. + u))
        x'   = min + q * unit

    ``compress`` returns ``(payload, ctx)``: payload is a dict of tensors
    (packed codes ``"q"`` and per-bucket ``"min"``/``"unit"``) that
    collectives can move. The ``*_rows`` forms quantize each row of a
    matrix on its own, as ``jax.vmap(compress)`` does, in one kernel
    launch.

    With ``stochastic=True`` the noise ``u`` of the value at index ``i`` of
    the padded layout is drawn from Philox4x32-10 under the seed of
    ``key`` (:func:`kernels.maxmin_quantize_stochastic`), so the row form
    draws what ``compress`` draws for the rows' padded concatenation.
    """

    def __init__(self, bits: int = 8, bucket_size: int = DEFAULT_BUCKET_SIZE,
                 stochastic: bool = False):
        if bits not in (1, 2, 4, 8):
            raise ValueError("bits must be one of 1, 2, 4, 8 (byte packing)")
        if bucket_size < 1:
            raise ValueError("bucket_size must be positive")
        self.bits = bits
        self.bucket_size = bucket_size
        self.stochastic = stochastic

    # A stochastic group never fuses with a deterministic one.
    def _key(self):
        return ("maxmin", self.bits, self.bucket_size, self.stochastic)

    def __repr__(self):
        return (f"MaxMinQuantizer(bits={self.bits}, "
                f"bucket_size={self.bucket_size}, "
                f"stochastic={self.stochastic})")

    def _quantize(self, flat: torch.Tensor, key):
        if self.stochastic:
            return kernels.maxmin_quantize_stochastic(
                flat, self.bits, self.bucket_size, seed_from_key(key))
        return kernels.maxmin_quantize(flat, self.bits, self.bucket_size)

    def compress(self, x: torch.Tensor, key: Key = None
                 ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        ctx = self.context(x.shape, x.dtype)
        flat = x.reshape(-1).to(torch.float32)
        q, mn, unit = self._quantize(flat.contiguous(), key)
        return {"q": _payload(q, self.bits, self.bucket_size), "min": mn,
                "unit": unit}, ctx

    def decompress(self, payload: Dict[str, torch.Tensor], ctx: QuantContext
                   ) -> torch.Tensor:
        out = kernels.maxmin_dequantize(
            payload["q"].reshape(1, -1), payload["min"].reshape(-1),
            payload["unit"].reshape(-1), ctx.bits, ctx.bucket_size)
        return out.view(-1)[:ctx.count].view(ctx.shape).to(ctx.dtype)

    def compress_rows(self, rows: torch.Tensor, key: Key = None
                      ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        """Quantize each row of ``rows [n, m]`` on its own; the payload's
        tensors gain a leading ``n`` and ``ctx`` describes one row."""
        n, m = rows.shape
        ctx = self.context((m,), rows.dtype)
        padded = self._padded(m)
        q, mn, unit = self._quantize(_padded_rows(rows, padded), key)
        return {"q": _payload(q, self.bits, self.bucket_size, n),
                "min": mn.view(n, -1), "unit": unit.view(n, -1)}, ctx

    def decompress_rows(self, payload: Dict[str, torch.Tensor],
                        ctx: QuantContext) -> torch.Tensor:
        """Inverse of :meth:`compress_rows`: ``[n, ctx.count]`` in
        ``ctx.dtype``."""
        q = payload["q"]
        out = kernels.maxmin_dequantize(
            q, payload["min"].reshape(-1), payload["unit"].reshape(-1),
            ctx.bits, ctx.bucket_size)
        padded = self._padded(ctx.count)
        return out.view(q.shape[0], padded)[:, :ctx.count].to(ctx.dtype)


# ---------------------------------------------------------------------------
# norm quantizer
# ---------------------------------------------------------------------------

# Level tables (reference: CPUNormalizedQuantizer levels, uniform or
# exponential, overridable at run time through set_quantization_levels,
# operations.cc:909). Built with numpy as the JAX package builds them, so the
# fp32 tables are bitwise the same.
_user_levels: Dict[str, np.ndarray] = {}


def set_quantization_levels(levels, for_type: str = "uni") -> None:
    """Override the norm quantizer's level table (reference:
    ``horovod_set_quantization_levels``, operations.cc:909). ``levels`` must
    be descending and end near 0; the first entry is scaled to 1.0."""
    arr = np.asarray(levels, dtype=np.float32).reshape(-1)
    if arr.size < 2:
        raise ValueError("need at least 2 levels")
    _user_levels[for_type] = arr / arr[0]


def default_levels(bits: int, kind: str) -> np.ndarray:
    """The descending fp32 level table of ``kind`` ("uni" or "exp") for
    ``bits`` bits, or the user's table for ``kind``."""
    if kind in _user_levels:
        return _user_levels[kind]
    n = 1 << (bits - 1)  # one bit goes to the sign
    if kind == "uni":
        return np.linspace(1.0, 0.0, n, dtype=np.float32)
    if kind == "exp":
        return np.array([2.0 ** -i for i in range(n - 1)] + [0.0],
                        dtype=np.float32)
    raise ValueError(f"unknown level kind {kind!r}")


@functools.lru_cache(maxsize=64)
def _table_on(table: bytes, device: torch.device
              ) -> norm_kernels.LevelTable:
    """A level table on ``device``, copied there and checked once
    (:class:`norm_kernels.LevelTable`)."""
    return norm_kernels.LevelTable(np.frombuffer(table, dtype=np.float32),
                                   device)


class NormalizedQuantizer(_Bucketed):
    """Norm-scaled quantization against a level table (reference:
    ``CPUNormalizedQuantizer``, compressor.h:219): per bucket,
    ``x ≈ sign(x) * norm * level[q]`` with norm = Linf or L2 and levels
    uniform ("uni") or exponential ("exp"). ``compress`` runs B5 and
    ``decompress`` B6 on the card; the payload is packed codes ``"q"`` and
    per-bucket ``"norm"``."""

    def __init__(self, bits: int = 4, bucket_size: int = DEFAULT_BUCKET_SIZE,
                 levels: str = "uni", norm: str = "linf"):
        if bits not in (2, 4, 8):
            raise ValueError("bits must be 2, 4 or 8")
        if norm not in ("l2", "linf"):
            raise ValueError(f"norm must be 'l2' or 'linf', got {norm!r}")
        if bucket_size < 1:
            raise ValueError("bucket_size must be positive")
        self.bits = bits
        self.bucket_size = bucket_size
        self.kind = levels
        self.norm = norm

    def _key(self):
        # The user's level table is part of the identity.
        lv = _user_levels.get(self.kind)
        return ("norm", self.bits, self.bucket_size, self.kind, self.norm,
                None if lv is None else lv.tobytes())

    def __repr__(self):
        return (f"NormalizedQuantizer(bits={self.bits}, "
                f"bucket_size={self.bucket_size}, levels={self.kind!r}, "
                f"norm={self.norm!r})")

    def _levels(self) -> np.ndarray:
        levels = default_levels(self.bits, self.kind)
        max_levels = 1 << (self.bits - 1)
        if levels.shape[0] > max_levels:
            raise ValueError(
                f"level table has {levels.shape[0]} entries but bits="
                f"{self.bits} can index at most {max_levels} — the packed "
                "index would overflow into neighboring values (did "
                "set_quantization_levels install a table too large for this "
                "quantizer?)")
        return levels

    def _table(self, device: torch.device) -> norm_kernels.LevelTable:
        return _table_on(self._levels().tobytes(), torch.device(device))

    def _quantize(self, flat: torch.Tensor):
        return norm_kernels.norm_quantize(flat, self._table(flat.device),
                                          self.bucket_size,
                                          self.norm == "l2", self.bits)

    def compress(self, x: torch.Tensor, key: Key = None
                 ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        ctx = self.context(x.shape, x.dtype)
        q, norm = self._quantize(x.reshape(-1).to(torch.float32).contiguous())
        return {"q": _payload(q, self.bits, self.bucket_size),
                "norm": norm}, ctx

    def _dequantize(self, packed: torch.Tensor, norm: torch.Tensor,
                    padded: int, bits: int) -> torch.Tensor:
        q = unpack_bits(packed, bits, padded).reshape(-1, self.bucket_size)
        return norm_kernels.norm_dequantize(q, self._table(q.device).levels,
                                            norm.reshape(-1))

    def decompress(self, payload: Dict[str, torch.Tensor], ctx: QuantContext
                   ) -> torch.Tensor:
        out = self._dequantize(payload["q"], payload["norm"],
                               self._padded(ctx.count), ctx.bits)
        return out.view(-1)[:ctx.count].view(ctx.shape).to(ctx.dtype)

    def compress_rows(self, rows: torch.Tensor, key: Key = None
                      ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        """Quantize each row of ``rows [n, m]`` on its own (``jax.vmap`` of
        ``compress``) in one launch; the payload's tensors gain a leading
        ``n`` and ``ctx`` describes one row."""
        n, m = rows.shape
        padded = self._padded(m)
        q, norm = self._quantize(_padded_rows(rows, padded))
        return {"q": _payload(q, self.bits, self.bucket_size, n),
                "norm": norm.view(n, -1)}, self.context((m,), rows.dtype)

    def decompress_rows(self, payload: Dict[str, torch.Tensor],
                        ctx: QuantContext) -> torch.Tensor:
        """Inverse of :meth:`compress_rows`: ``[n, ctx.count]`` in
        ``ctx.dtype``, in one launch."""
        padded = self._padded(ctx.count)
        out = self._dequantize(payload["q"], payload["norm"], padded,
                               ctx.bits)
        n = payload["q"].shape[0]
        return out.view(n, padded)[:, :ctx.count].to(ctx.dtype)


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------

class TopKCompressor(_Keyed):
    """Keep the top ``ratio`` fraction of entries by magnitude (reference:
    ``GPUTopKCompressor``, ``topk_compression.cu``; ratio knob
    ``HOROVOD_COMPRESSION_TOPK_RATIO``). The payload is the kept
    ``"values"`` (fp32) and their ``"indices"`` (int32)."""

    def __init__(self, ratio: float = 0.01):
        if not 0 < ratio <= 1:
            raise ValueError("ratio must be in (0, 1]")
        self.ratio = ratio

    def _key(self):
        return ("topk", self.ratio)

    def __repr__(self):
        return f"TopKCompressor(ratio={self.ratio})"

    def context(self, shape, dtype: torch.dtype) -> QuantContext:
        return QuantContext(shape=tuple(shape), dtype=dtype,
                            count=math.prod(shape), bits=32, bucket_size=0)

    def _k(self, count: int) -> int:
        return max(1, int(count * self.ratio))

    def compress(self, x: torch.Tensor, key: Key = None
                 ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        payload, _ = self.compress_rows(x.reshape(1, -1))
        return ({k: v[0] for k, v in payload.items()},
                self.context(x.shape, x.dtype))

    def decompress(self, payload: Dict[str, torch.Tensor], ctx: QuantContext
                   ) -> torch.Tensor:
        one = {k: v[None] for k, v in payload.items()}
        return self.decompress_rows(one, ctx)[0].view(ctx.shape)

    def compress_rows(self, rows: torch.Tensor, key: Key = None
                      ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        """The top entries of each row of ``rows [n, m]``."""
        rows = rows.to(torch.float32)
        _, idx = torch.topk(rows.abs(), self._k(rows.shape[1]), dim=1)
        return ({"values": torch.gather(rows, 1, idx),
                 "indices": idx.to(torch.int32)},
                self.context((rows.shape[1],), rows.dtype))

    def decompress_rows(self, payload: Dict[str, torch.Tensor],
                        ctx: QuantContext) -> torch.Tensor:
        values = payload["values"]
        out = torch.zeros((values.shape[0], ctx.count), dtype=torch.float32,
                          device=values.device)
        out.scatter_(1, payload["indices"].to(torch.int64), values)
        return out.to(ctx.dtype)


def compressed_size_bytes(payload: Dict[str, torch.Tensor]) -> int:
    """Wire size of a compressed payload."""
    return sum(t.numel() * t.element_size() for t in payload.values())
