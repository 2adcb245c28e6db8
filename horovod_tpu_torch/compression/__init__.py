"""Gradient compression (counterpart of ``horovod_tpu/compression/``).

Reference surface: ``horovod/torch/compression.py`` (``Compressor`` /
``NoneCompressor`` / ``FP16Compressor`` / ``Compression``) plus the
IST-DASLab quantizers (max-min, deterministic or stochastic, and
normalized), top-k, error feedback and the five compressed reducers.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: compress a tensor for the wire, decompress the reduced
    result (reference: ``horovod/torch/compression.py:23``)."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Pass-through (reference: ``compression.py:37``)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), ctx
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    """Cast floating tensors to float16 on the wire
    (reference: ``compression.py:48``)."""
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast floating tensors to bfloat16 on the wire (fp32 range, no
    overflow on large gradients)."""
    wire_dtype = torch.bfloat16


class Compression:
    """Namespace of the wire compressors (reference: ``compression.py:60``)."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor


from .quantize import (DEFAULT_BUCKET_SIZE, MaxMinQuantizer,  # noqa: E402
                       NormalizedQuantizer, QuantContext, TopKCompressor,
                       compressed_size_bytes, pack_bits,
                       set_quantization_levels, unpack_bits)
from .error_feedback import (compress_with_feedback,  # noqa: E402
                             init_error_feedback)
from .reducers import (compressed_allreduce,  # noqa: E402
                       compressed_grouped_allreduce,
                       hierarchical_compressed_allreduce,
                       hierarchical_compressed_residual_zeros)
from .config import (CompressionConfig, LayerRule, from_env,  # noqa: E402
                     make_compressor)
