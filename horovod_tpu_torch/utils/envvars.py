"""Environment-variable knobs the port reads.

A copy of the part of ``horovod_tpu/utils/envvars.py`` this slice needs: the
topology the ``hvdrun`` launcher exports (reference: ``HOROVOD_RANK``/...
from ``horovod/runner/gloo_run.py:70-95``), the rendezvous address, the
compression factory's knobs (reference: ``mpi_compressed_operations.cc:12-75``),
the gradient buckets' size (reference: ``HOROVOD_FUSION_THRESHOLD``,
``horovod_tpu/basics.py:292``), the device mesh (``HVDTPU_MESH_SHAPE``,
``horovod_tpu/utils/envvars.py:350``), the flat-or-hierarchical
calibration's log (``HVDTPU_AUTOTUNE_LOG``, ``:242``; reference:
``HOROVOD_AUTOTUNE_LOG``) and the log level.
"""

from __future__ import annotations

import os
from typing import Optional

HVDTPU_RANK = "HVDTPU_RANK"
HVDTPU_SIZE = "HVDTPU_SIZE"
HVDTPU_LOCAL_RANK = "HVDTPU_LOCAL_RANK"
HVDTPU_LOCAL_SIZE = "HVDTPU_LOCAL_SIZE"
HVDTPU_CROSS_RANK = "HVDTPU_CROSS_RANK"
HVDTPU_CROSS_SIZE = "HVDTPU_CROSS_SIZE"
HVDTPU_CONTROLLER_ADDR = "HVDTPU_CONTROLLER_ADDR"
HVDTPU_CONTROLLER_PORT = "HVDTPU_CONTROLLER_PORT"

# torchrun's names, read when the hvdrun ones are absent.
RANK = "RANK"
WORLD_SIZE = "WORLD_SIZE"
LOCAL_RANK = "LOCAL_RANK"
LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"

HVDTPU_LOG_LEVEL = "HVDTPU_LOG_LEVEL"

# Bytes of one DistributedOptimizer bucket of dense gradients.
HVDTPU_FUSION_THRESHOLD = "HVDTPU_FUSION_THRESHOLD"
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024

# The device mesh when init() is given none, as "dcn=2,ici=4": one entry an
# axis, in row-major order, their product the world size.
HVDTPU_MESH_SHAPE = "HVDTPU_MESH_SHAPE"
# Where autotune_hierarchical saves its table and choose_hierarchical
# loads it from on its first uncalibrated query.
HVDTPU_AUTOTUNE_LOG = "HVDTPU_AUTOTUNE_LOG"

HVDTPU_COMPRESSION = "HVDTPU_COMPRESSION"
HVDTPU_REDUCTION = "HVDTPU_REDUCTION"
HVDTPU_QUANTIZATION_BITS = "HVDTPU_QUANTIZATION_BITS"
HVDTPU_COMPRESSION_BUCKET_SIZE = "HVDTPU_COMPRESSION_BUCKET_SIZE"
HVDTPU_COMPRESSION_ERROR_FEEDBACK = "HVDTPU_COMPRESSION_ERROR_FEEDBACK"
HVDTPU_COMPRESSION_CONFIG_FILE = "HVDTPU_COMPRESSION_CONFIG_FILE"
HVDTPU_COMPRESSION_NORM_TYPE = "HVDTPU_COMPRESSION_NORM_TYPE"
HVDTPU_COMPRESSION_TOPK_RATIO = "HVDTPU_COMPRESSION_TOPK_RATIO"


def get_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


def get_float(name: str, default: Optional[float]) -> Optional[float]:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {v!r}") from None


def get_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v
