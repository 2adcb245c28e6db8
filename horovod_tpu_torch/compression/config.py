"""Per-layer compression configuration and the env-driven factory.

Counterpart of ``horovod_tpu/compression/config.py``; reference: the fork's
YAML config (``HOROVOD_COMPRESSION_CONFIG_FILE``, ``compressor.cc``
ParseYaml) with per-module compressor / bits / bucket_size / ignore rules,
and the env factory in ``mpi_compressed_operations.cc:12-75``
(``HOROVOD_COMPRESSION``: MaxMin/Uni/Exp/TopK, ``HOROVOD_QUANTIZATION_BITS``,
``HOROVOD_COMPRESSION_BUCKET_SIZE``, ``HOROVOD_COMPRESSION_TOPK_RATIO``,
``HOROVOD_COMPRESSION_ERROR_FEEDBACK``, ``HOROVOD_REDUCTION``).

Schema (YAML)::

    default:
      compressor: maxmin    # maxmin | uni | exp | topk | fp16 | bf16 | none
      bits: 4
      bucket_size: 512
    layers:
      - pattern: ".*bias.*" # regex on the parameter's name
        ignore: true        # leave uncompressed
      - pattern: "fc\\..*"
        bits: 8
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

from ..utils import envvars as ev
from . import BF16Compressor, FP16Compressor
from .quantize import (DEFAULT_BUCKET_SIZE, MaxMinQuantizer,
                       NormalizedQuantizer, TopKCompressor)


def make_compressor(name: str, bits: int = 4,
                    bucket_size: int = DEFAULT_BUCKET_SIZE,
                    topk_ratio: float = 0.01, norm: str = "linf"):
    """A compressor by name: ``maxmin``, ``int8``/``int4`` (max-min at that
    width), ``uni``/``exp`` (the normalized quantizer with that level table
    and ``norm``), ``topk`` (keeping ``topk_ratio`` of the values),
    ``fp16``, ``bf16``, or ``none`` (returns None)."""
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
    if name in ("uni", "exp"):
        return NormalizedQuantizer(bits=bits, bucket_size=bucket_size,
                                   levels=name, norm=norm)
    if name == "topk":
        return TopKCompressor(ratio=topk_ratio)
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

    @classmethod
    def load(cls, path: str, reduction: str = "scatter_allgather",
             error_feedback: bool = False,
             norm: str = "linf") -> "CompressionConfig":
        """The config of a YAML file (schema in the module docstring). A
        layer rule that names any of compressor, bits, bucket_size,
        topk_ratio or norm gets its own compressor, the rest taken from
        ``default``."""
        import yaml  # only here: the card's image may lack PyYAML
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        d = doc.get("default", {})

        def build(rule):
            return make_compressor(
                rule.get("compressor", d.get("compressor", "maxmin")),
                bits=int(rule.get("bits", d.get("bits", 4))),
                bucket_size=int(rule.get("bucket_size",
                                         d.get("bucket_size",
                                               DEFAULT_BUCKET_SIZE))),
                topk_ratio=float(rule.get("topk_ratio",
                                          d.get("topk_ratio", 0.01))),
                norm=rule.get("norm", d.get("norm", norm)))

        rules = []
        for r in doc.get("layers", []):
            own = any(k in r for k in ("compressor", "bits", "bucket_size",
                                        "topk_ratio", "norm"))
            rules.append(LayerRule(pattern=re.compile(r["pattern"]),
                                   ignore=bool(r.get("ignore", False)),
                                   compressor=build(r) if own else None))
        return cls(default_compressor=build({}), rules=rules,
                   reduction=reduction, error_feedback=error_feedback)


def from_env() -> Optional[CompressionConfig]:
    """The compression config from ``HVDTPU_*`` variables; None when
    compression is off. ``HVDTPU_COMPRESSION_CONFIG_FILE`` names a YAML
    config that takes the place of the other compressor variables."""
    reduction = ev.get_str(ev.HVDTPU_REDUCTION, "scatter_allgather").lower()
    error_feedback = ev.get_bool(ev.HVDTPU_COMPRESSION_ERROR_FEEDBACK)
    norm = ev.get_str(ev.HVDTPU_COMPRESSION_NORM_TYPE, "linf").lower()
    cfg_file = ev.get_str(ev.HVDTPU_COMPRESSION_CONFIG_FILE)
    if cfg_file:
        return CompressionConfig.load(cfg_file, reduction=reduction,
                                      error_feedback=error_feedback,
                                      norm=norm)
    name = ev.get_str(ev.HVDTPU_COMPRESSION, "none")
    if name.lower() in ("none", "auto"):
        # "auto" is the native wire autotuner's choice; nothing to build.
        return None
    comp = make_compressor(
        name, bits=ev.get_int(ev.HVDTPU_QUANTIZATION_BITS, 4),
        bucket_size=ev.get_int(ev.HVDTPU_COMPRESSION_BUCKET_SIZE,
                               DEFAULT_BUCKET_SIZE),
        topk_ratio=ev.get_float(ev.HVDTPU_COMPRESSION_TOPK_RATIO, 0.01),
        norm=norm)
    return CompressionConfig(default_compressor=comp, reduction=reduction,
                             error_feedback=error_feedback)
