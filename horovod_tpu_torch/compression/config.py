"""Per-layer compression configuration and the env-driven factory.

Counterpart of ``horovod_tpu/compression/config.py``; reference: the fork's
env factory in ``mpi_compressed_operations.cc:12-75`` (``HOROVOD_COMPRESSION``,
``HOROVOD_QUANTIZATION_BITS``, ``HOROVOD_COMPRESSION_BUCKET_SIZE``,
``HOROVOD_COMPRESSION_ERROR_FEEDBACK``, ``HOROVOD_REDUCTION``). The YAML
loader and the norm / top-k compressors come with later slices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

from ..utils import envvars as ev
from . import BF16Compressor, FP16Compressor
from .quantize import DEFAULT_BUCKET_SIZE, MaxMinQuantizer

_LATER = ("uni", "exp", "topk")


def make_compressor(name: str, bits: int = 4,
                    bucket_size: int = DEFAULT_BUCKET_SIZE):
    """A compressor by name: ``maxmin``, ``int8``/``int4`` (max-min at that
    width), ``fp16``, ``bf16``, or ``none`` (returns None)."""
    name = (name or "none").lower()
    if name == "none":
        return None
    if name == "fp16":
        return FP16Compressor
    if name == "bf16":
        return BF16Compressor
    if name == "maxmin":
        return MaxMinQuantizer(bits=bits, bucket_size=bucket_size)
    if name == "int8":
        return MaxMinQuantizer(bits=8, bucket_size=bucket_size)
    if name == "int4":
        return MaxMinQuantizer(bits=4, bucket_size=bucket_size)
    if name in _LATER:
        raise NotImplementedError(f"compressor {name!r} is not ported yet")
    raise ValueError(f"unknown compressor {name!r}")


@dataclasses.dataclass
class LayerRule:
    pattern: re.Pattern
    ignore: bool = False
    compressor: Optional[object] = None


class CompressionConfig:
    """Resolves a compressor per gradient, by parameter name."""

    def __init__(self, default_compressor=None,
                 rules: Optional[List[LayerRule]] = None,
                 reduction: str = "scatter_allgather",
                 error_feedback: bool = False):
        self.default_compressor = default_compressor
        self.rules = rules or []
        self.reduction = reduction
        self.error_feedback = error_feedback

    def for_name(self, name: str):
        """Compressor for a named gradient, or None to skip compression."""
        for rule in self.rules:
            if rule.pattern.search(name):
                return None if rule.ignore else (rule.compressor or
                                                 self.default_compressor)
        return self.default_compressor


def from_env() -> Optional[CompressionConfig]:
    """The compression config from ``HVDTPU_*`` variables; None when
    compression is off."""
    if ev.get_str(ev.HVDTPU_COMPRESSION_CONFIG_FILE):
        raise NotImplementedError(
            f"{ev.HVDTPU_COMPRESSION_CONFIG_FILE} (the YAML per-layer "
            "config) is not ported yet")
    name = ev.get_str(ev.HVDTPU_COMPRESSION, "none")
    if name.lower() in ("none", "auto"):
        # "auto" is the native wire autotuner's choice; nothing to build.
        return None
    comp = make_compressor(
        name, bits=ev.get_int(ev.HVDTPU_QUANTIZATION_BITS, 4),
        bucket_size=ev.get_int(ev.HVDTPU_COMPRESSION_BUCKET_SIZE,
                               DEFAULT_BUCKET_SIZE))
    return CompressionConfig(
        default_compressor=comp,
        reduction=ev.get_str(ev.HVDTPU_REDUCTION,
                             "scatter_allgather").lower(),
        error_feedback=ev.get_bool(ev.HVDTPU_COMPRESSION_ERROR_FEEDBACK))
