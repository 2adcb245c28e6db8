"""Environment-variable knobs the port reads.

A copy of the part of ``horovod_tpu/utils/envvars.py`` this slice needs: the
topology the ``hvdrun`` launcher exports (reference: ``HOROVOD_RANK``/...
from ``horovod/runner/gloo_run.py:70-95``), the rendezvous address, the
compression factory's knobs (reference: ``mpi_compressed_operations.cc:12-75``),
the gradient buckets' size (reference: ``HOROVOD_FUSION_THRESHOLD``,
``horovod_tpu/basics.py:292``), the device mesh (``HVDTPU_MESH_SHAPE``,
``horovod_tpu/utils/envvars.py:350``), the flat-or-hierarchical
calibration's log (``HVDTPU_AUTOTUNE_LOG``, ``:242``; reference:
``HOROVOD_AUTOTUNE_LOG``), PowerSGD's residual cap and warning
(``:361-362``), the log level, and every knob the process-mode native
core reads at ``init(mode="process")`` (``horovod_tpu/basics.py:283-577``:
the controller, the background loop, the data plane's algorithms and
transports, wire compression, stall and failure detection, the flight
recorder, perf and gradient statistics, the profiler, tracing and
autotuning), with the JAX package's names and defaults.
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

# The launcher and the elastic driver (horovod_tpu/utils/envvars.py:31-39,
# :326, :377-392): the address other hosts reach this one on, the elastic
# driver's key-value store and a worker's stable identity there, how long
# a worker waits for its assignment, the store that carries ``run()``'s
# function and results, and the connectivity probe's parameters.
HVDTPU_ADVERTISE_ADDR = "HVDTPU_ADVERTISE_ADDR"
HVDTPU_RENDEZVOUS_ADDR = "HVDTPU_RENDEZVOUS_ADDR"
HVDTPU_RENDEZVOUS_PORT = "HVDTPU_RENDEZVOUS_PORT"
HVDTPU_WORKER_ID = "HVDTPU_WORKER_ID"
HVDTPU_ELASTIC_TIMEOUT = "HVDTPU_ELASTIC_TIMEOUT"
HVDTPU_RUN_KV_ADDR = "HVDTPU_RUN_KV_ADDR"
HVDTPU_RUN_KV_PORT = "HVDTPU_RUN_KV_PORT"
# The device run()'s workers initialize on (unset: the card).
HVDTPU_RUN_DEVICE = "HVDTPU_RUN_DEVICE"
HVDTPU_PREFLIGHT_KV_ADDR = "HVDTPU_PREFLIGHT_KV_ADDR"
HVDTPU_PREFLIGHT_KV_PORT = "HVDTPU_PREFLIGHT_KV_PORT"
HVDTPU_PREFLIGHT_HOST = "HVDTPU_PREFLIGHT_HOST"
HVDTPU_PREFLIGHT_ROLE = "HVDTPU_PREFLIGHT_ROLE"
HVDTPU_PREFLIGHT_CONTROLLER = "HVDTPU_PREFLIGHT_CONTROLLER"
HVDTPU_PREFLIGHT_TIMEOUT = "HVDTPU_PREFLIGHT_TIMEOUT"
# The live-metrics endpoints' base port (rank r serves on base + r) and
# the launcher's scrape period (:256-257).
HVDTPU_METRICS_PORT = "HVDTPU_METRICS_PORT"
HVDTPU_METRICS_INTERVAL = "HVDTPU_METRICS_INTERVAL"

# torchrun's names, read when the hvdrun ones are absent.
RANK = "RANK"
WORLD_SIZE = "WORLD_SIZE"
LOCAL_RANK = "LOCAL_RANK"
LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"

HVDTPU_LOG_LEVEL = "HVDTPU_LOG_LEVEL"
# Leave the time out of each log record (reference: HOROVOD_LOG_HIDE_TIME).
HVDTPU_LOG_HIDE_TIME = "HVDTPU_LOG_HIDE_TIME"

# Bytes of one DistributedOptimizer bucket of dense gradients.
HVDTPU_FUSION_THRESHOLD = "HVDTPU_FUSION_THRESHOLD"
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024

# The device mesh when init() is given none, as "dcn=2,ici=4": one entry an
# axis, in row-major order, their product the world size.
HVDTPU_MESH_SHAPE = "HVDTPU_MESH_SHAPE"
# Where autotune_hierarchical saves its table and choose_hierarchical
# loads it from on its first uncalibrated query.
HVDTPU_AUTOTUNE_LOG = "HVDTPU_AUTOTUNE_LOG"

# PowerSGD's residual state, reckoned globally (world x fp32 gradients):
# a hard cap in bytes (unset: none), and the size above which init warns.
HVDTPU_POWERSGD_RESIDUAL_CAP = "HVDTPU_POWERSGD_RESIDUAL_CAP"
HVDTPU_POWERSGD_RESIDUAL_WARN = "HVDTPU_POWERSGD_RESIDUAL_WARN"
DEFAULT_POWERSGD_RESIDUAL_WARN = 1 << 30

HVDTPU_COMPRESSION = "HVDTPU_COMPRESSION"
HVDTPU_REDUCTION = "HVDTPU_REDUCTION"
HVDTPU_QUANTIZATION_BITS = "HVDTPU_QUANTIZATION_BITS"
HVDTPU_COMPRESSION_BUCKET_SIZE = "HVDTPU_COMPRESSION_BUCKET_SIZE"
HVDTPU_COMPRESSION_ERROR_FEEDBACK = "HVDTPU_COMPRESSION_ERROR_FEEDBACK"
HVDTPU_COMPRESSION_CONFIG_FILE = "HVDTPU_COMPRESSION_CONFIG_FILE"
HVDTPU_COMPRESSION_NORM_TYPE = "HVDTPU_COMPRESSION_NORM_TYPE"
HVDTPU_COMPRESSION_TOPK_RATIO = "HVDTPU_COMPRESSION_TOPK_RATIO"


# ---------------------------------------------------------------------------
# The process-mode native core (horovod_tpu/utils/envvars.py:26-330)
# ---------------------------------------------------------------------------

HVDTPU_HOSTNAME = "HVDTPU_HOSTNAME"
HVDTPU_SECRET = "HVDTPU_SECRET"
HVDTPU_CYCLE_TIME = "HVDTPU_CYCLE_TIME"

# Allreduce algorithm: auto | ring | recursive_doubling | tree |
# scatter_allgather | parameter_server (hvdtpu::AllreduceAlgo).
HVDTPU_ALLREDUCE_ALGO = "HVDTPU_ALLREDUCE_ALGO"
HVDTPU_ALLREDUCE_CROSSOVER = "HVDTPU_ALLREDUCE_CROSSOVER"
HVDTPU_ALLREDUCE_SEGMENT_BYTES = "HVDTPU_ALLREDUCE_SEGMENT_BYTES"
HVDTPU_ALLREDUCE_SA_GROUP = "HVDTPU_ALLREDUCE_SA_GROUP"
ALLREDUCE_ALGOS = ("auto", "ring", "recursive_doubling", "tree",
                   "scatter_allgather", "parameter_server")
HVDTPU_CTRL_BATCH = "HVDTPU_CTRL_BATCH"
HVDTPU_BCAST_FLAT_MAX = "HVDTPU_BCAST_FLAT_MAX"

# Transports: shared-memory lanes between ranks of one host (else TCP), the
# two-level allreduce, zero-copy TCP sends, NUMA placement of the rings and
# the doorbell's coalescing window.
HVDTPU_SHM = "HVDTPU_SHM"
HVDTPU_SHM_RING_BYTES = "HVDTPU_SHM_RING_BYTES"
HVDTPU_ALLREDUCE_HIER = "HVDTPU_ALLREDUCE_HIER"
ALLREDUCE_HIER_MODES = {"0": 0, "off": 0, "false": 0,
                        "1": 1, "on": 1, "true": 1,
                        "auto": 2, "": 2}
HVDTPU_TCP_ZEROCOPY = "HVDTPU_TCP_ZEROCOPY"
HVDTPU_SHM_NUMA = "HVDTPU_SHM_NUMA"
HVDTPU_DOORBELL_BATCH = "HVDTPU_DOORBELL_BATCH"
TCP_ZEROCOPY_MODES = {"auto": 0, "on": 1, "off": 2, "uring": 3}
SHM_NUMA_MODES = {"auto": 0, "on": 1, "off": 2}

# Response cache, stall inspector, timeline, tracing.
HVDTPU_CACHE_CAPACITY = "HVDTPU_CACHE_CAPACITY"
HVDTPU_STALL_CHECK_DISABLE = "HVDTPU_STALL_CHECK_DISABLE"
HVDTPU_STALL_CHECK_TIME_SECONDS = "HVDTPU_STALL_CHECK_TIME_SECONDS"
HVDTPU_STALL_SHUTDOWN_TIME_SECONDS = "HVDTPU_STALL_SHUTDOWN_TIME_SECONDS"
HVDTPU_TIMELINE = "HVDTPU_TIMELINE"
HVDTPU_TIMELINE_MARK_CYCLES = "HVDTPU_TIMELINE_MARK_CYCLES"
HVDTPU_TRACE = "HVDTPU_TRACE"
HVDTPU_TRACE_SAMPLE = "HVDTPU_TRACE_SAMPLE"
HVDTPU_TRACE_CLOCK_SYNC_SECONDS = "HVDTPU_TRACE_CLOCK_SYNC_SECONDS"
DEFAULT_TRACE_SAMPLE = 10

# Flight recorder, perf attribution, gradient statistics, profiler.
HVDTPU_FLIGHTREC = "HVDTPU_FLIGHTREC"
HVDTPU_FLIGHTREC_EVENTS = "HVDTPU_FLIGHTREC_EVENTS"
HVDTPU_FLIGHTREC_DIR = "HVDTPU_FLIGHTREC_DIR"
DEFAULT_FLIGHTREC_EVENTS = 4096
MAX_FLIGHTREC_EVENTS = 16 * 1024 * 1024
HVDTPU_PERFSTATS = "HVDTPU_PERFSTATS"
HVDTPU_PERF_SLOWDOWN_PCT = "HVDTPU_PERF_SLOWDOWN_PCT"
HVDTPU_PERF_MIN_SAMPLES = "HVDTPU_PERF_MIN_SAMPLES"
HVDTPU_PERF_PROFILE_DIR = "HVDTPU_PERF_PROFILE_DIR"
DEFAULT_PERF_SLOWDOWN_PCT = 50.0
DEFAULT_PERF_MIN_SAMPLES = 20
HVDTPU_GRADSTATS = "HVDTPU_GRADSTATS"
HVDTPU_NANCHECK = "HVDTPU_NANCHECK"
HVDTPU_GRADCHECK_SAMPLE = "HVDTPU_GRADCHECK_SAMPLE"
HVDTPU_GRAD_PROFILE_DIR = "HVDTPU_GRAD_PROFILE_DIR"
DEFAULT_GRADCHECK_SAMPLE = 64
# hvdtpu::NanPolicy (native/gradstats.h).
NAN_POLICIES = {"off": 0, "warn": 1, "abort": 2}
HVDTPU_PROF = "HVDTPU_PROF"
HVDTPU_PROF_HZ = "HVDTPU_PROF_HZ"
HVDTPU_PROF_CLOCK = "HVDTPU_PROF_CLOCK"
HVDTPU_PROF_DIR = "HVDTPU_PROF_DIR"
DEFAULT_PROF_HZ = 97
MAX_PROF_HZ = 1000
PROF_CLOCK_MODES = {"cpu": 0, "wall": 1}

# Autotuner (HVDTPU_AUTOTUNE_LOG is declared above).
HVDTPU_AUTOTUNE = "HVDTPU_AUTOTUNE"
HVDTPU_AUTOTUNE_WARMUP_SAMPLES = "HVDTPU_AUTOTUNE_WARMUP_SAMPLES"
HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE = "HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE"
HVDTPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "HVDTPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HVDTPU_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = \
    "HVDTPU_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"

# Wire compression of the core's allreduce payloads. HVDTPU_COMPRESSION is
# the selector: none | fp16 | int8 | int4 | auto; "maxmin" rides
# HVDTPU_QUANTIZATION_BITS (8 -> int8, 4 -> int4, else dense); the names of
# compressors that only the Python reducers run keep the wire dense.
HVDTPU_COMPRESSION_MIN_BYTES = "HVDTPU_COMPRESSION_MIN_BYTES"
HVDTPU_COMPRESSION_SKIP_REGEX = "HVDTPU_COMPRESSION_SKIP_REGEX"
WIRE_COMPRESSION_MODES = {"none": 0, "fp16": 1, "int8": 2, "int4": 3,
                          "auto": 4}
PYTHON_ONLY_COMPRESSORS = ("bf16", "uni", "exp", "topk")
DEFAULT_COMPRESSION_MIN_BYTES = 1024
DEFAULT_COMPRESSION_SKIP_REGEX = r"bias|batch_?norm|layer_?norm"

# Failure detection and fault injection.
HVDTPU_FAILURE_DETECT_MS = "HVDTPU_FAILURE_DETECT_MS"
HVDTPU_READ_DEADLINE_SECONDS = "HVDTPU_READ_DEADLINE_SECONDS"
HVDTPU_FORMUP_TIMEOUT_SECONDS = "HVDTPU_FORMUP_TIMEOUT_SECONDS"
HVDTPU_CHAOS = "HVDTPU_CHAOS"
HVDTPU_CHAOS_MARKER = "HVDTPU_CHAOS_MARKER"


def get_wire_compression(name: str, bits: int = 4) -> int:
    """The ``hvdtpu::WireCompression`` code of an ``HVDTPU_COMPRESSION``
    value (JAX ``envvars.py:276-295``)."""
    name = (name or "none").strip().lower()
    if name in WIRE_COMPRESSION_MODES:
        return WIRE_COMPRESSION_MODES[name]
    if name == "maxmin":
        if bits == 8:
            return WIRE_COMPRESSION_MODES["int8"]
        if bits == 4:
            return WIRE_COMPRESSION_MODES["int4"]
        return WIRE_COMPRESSION_MODES["none"]
    if name in PYTHON_ONLY_COMPRESSORS:
        return WIRE_COMPRESSION_MODES["none"]
    raise ValueError(
        f"{HVDTPU_COMPRESSION} must be one of "
        f"{sorted(WIRE_COMPRESSION_MODES)} + "
        f"{sorted(('maxmin',) + PYTHON_ONLY_COMPRESSORS)}, got {name!r}")


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


def get_required(name: str) -> str:
    """A variable the launcher must have set (the probe's and the task
    runner's parameters); KeyError when it is absent."""
    return os.environ[name]
