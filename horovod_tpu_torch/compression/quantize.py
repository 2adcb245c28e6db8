"""Bucketed max-min quantization (counterpart of
``horovod_tpu/compression/quantize.py``: ``pack_bits``/``unpack_bits``
:36-58, ``QuantContext`` :110-117,
``MaxMinQuantizer`` :120-207).

Reference: the IST-DASLab fork's ``CPUMaxMinQuantizer``
(``compressor.h:168``), default bucket size 512 (``compressor.h:11``).
Quantize runs kernel B1 and decompress kernel B4 on the card
(:mod:`horovod_tpu_torch.compression.kernels`); packing the codes into
bytes stays plain PyTorch, as it is plain jnp in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import kernels

DEFAULT_BUCKET_SIZE = 512  # reference: compressor.h:11


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
    row."""
    if bits == 8:
        return p[..., :count]
    per = 8 // bits
    shifts = torch.arange(0, 8, bits, dtype=torch.uint8, device=p.device)
    vals = (p.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*p.shape[:-1], -1)[..., :count]


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


class MaxMinQuantizer:
    """Bucket-wise linear quantization to ``bits`` bits
    (reference: ``CPUMaxMinQuantizer``, compressor.h:168)::

        unit = (max - min) / (2**bits - 1)
        q    = round_half_even((x - min) / unit)
        x'   = min + q * unit

    ``compress`` returns ``(payload, ctx)``: payload is a dict of tensors
    (packed codes ``"q"`` and per-bucket ``"min"``/``"unit"``) that
    collectives can move. The ``*_rows`` forms quantize each row of a
    matrix on its own, as ``jax.vmap(compress)`` does, in one kernel
    launch.
    """

    def __init__(self, bits: int = 8, bucket_size: int = DEFAULT_BUCKET_SIZE,
                 stochastic: bool = False):
        if bits not in (1, 2, 4, 8):
            raise ValueError("bits must be one of 1, 2, 4, 8 (byte packing)")
        if bucket_size < 1:
            raise ValueError("bucket_size must be positive")
        if stochastic:
            raise NotImplementedError(
                "stochastic rounding needs kernel B2 "
                "(maxmin_quantize_stochastic_pallas), which is not ported "
                "yet")
        self.bits = bits
        self.bucket_size = bucket_size

    # Equal-config quantizers are equal, so the optimizer fuses the leaves
    # of equal quantizers into one group.
    def _key(self):
        return ("maxmin", self.bits, self.bucket_size)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, MaxMinQuantizer) and \
            other._key() == self._key()

    def __repr__(self):
        return (f"MaxMinQuantizer(bits={self.bits}, "
                f"bucket_size={self.bucket_size})")

    def _padded(self, count: int) -> int:
        return -(-count // self.bucket_size) * self.bucket_size

    def compress(self, x: torch.Tensor
                 ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        ctx = QuantContext(shape=tuple(x.shape), dtype=x.dtype,
                           count=math.prod(x.shape), bits=self.bits,
                           bucket_size=self.bucket_size)
        flat = x.reshape(-1).to(torch.float32)
        q, mn, unit = kernels.maxmin_quantize(flat.contiguous(), self.bits,
                                              self.bucket_size)
        return {"q": pack_bits(q.view(-1), self.bits), "min": mn,
                "unit": unit}, ctx

    def decompress(self, payload: Dict[str, torch.Tensor], ctx: QuantContext
                   ) -> torch.Tensor:
        q = unpack_bits(payload["q"], ctx.bits, self._padded(ctx.count))
        out = kernels.maxmin_dequantize(
            q.reshape(-1, ctx.bucket_size), payload["min"].reshape(-1),
            payload["unit"].reshape(-1))
        return out.view(-1)[:ctx.count].view(ctx.shape).to(ctx.dtype)

    def compress_rows(self, rows: torch.Tensor
                      ) -> Tuple[Dict[str, torch.Tensor], QuantContext]:
        """Quantize each row of ``rows [n, m]`` on its own; the payload's
        tensors gain a leading ``n`` and ``ctx`` describes one row."""
        n, m = rows.shape
        ctx = QuantContext(shape=(m,), dtype=rows.dtype, count=m,
                           bits=self.bits, bucket_size=self.bucket_size)
        padded = self._padded(m)
        rows = rows.to(torch.float32)
        if padded != m:
            rows = F.pad(rows, (0, padded - m))
        q, mn, unit = kernels.maxmin_quantize(rows.reshape(-1), self.bits,
                                              self.bucket_size)
        return {"q": pack_bits(q.view(n, padded), self.bits),
                "min": mn.view(n, -1), "unit": unit.view(n, -1)}, ctx

    def decompress_rows(self, payload: Dict[str, torch.Tensor],
                        ctx: QuantContext) -> torch.Tensor:
        """Inverse of :meth:`compress_rows`: ``[n, ctx.count]`` in
        ``ctx.dtype``."""
        padded = self._padded(ctx.count)
        q = unpack_bits(payload["q"], ctx.bits, padded)
        n = q.shape[0]
        out = kernels.maxmin_dequantize(
            q.reshape(-1, ctx.bucket_size), payload["min"].reshape(-1),
            payload["unit"].reshape(-1))
        return out.view(n, padded)[:, :ctx.count].to(ctx.dtype)
