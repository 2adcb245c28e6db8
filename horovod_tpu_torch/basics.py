"""ctypes binding to the process-mode native core.

Counterpart of ``horovod_tpu/basics.py`` (``_C_API`` :95-222,
``register_c_api`` :224, ``_raise_for`` :249, ``NativeCore`` :272-899)
over torch tensors; reference surface ``horovod/common/basics.py:22``. The
C API is the one exported by the port's own copy of the core,
``horovod_tpu_torch/native/core.cpp`` (the TCP controller, the ring data
plane and their shared-memory lanes), built into
``horovod_tpu_torch/_build/`` by :mod:`horovod_tpu_torch.utils.native_build`
at first use.

The core reads and writes host memory: :meth:`NativeCore.enqueue` takes a
contiguous CPU tensor and passes its ``data_ptr()``, which the core's
thread reads while the operation is in flight (the tensor is kept alive
until :meth:`NativeCore.wait`), and ``wait`` copies the result into a new
CPU tensor, pinned when asked, so that it can go back to the card with a
``non_blocking`` copy.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Optional

import torch

from .exceptions import (DuplicateNameError, HvdTpuInternalError,
                         TensorDtypeMismatchError, TensorShapeMismatchError)
from .utils import envvars as ev
from .utils import logging as log

# hvdtpu::OpType (native/common.h).
_OP_TYPES = {"allreduce": 0, "allgather": 1, "broadcast": 2, "alltoall": 3,
             "reducescatter": 4, "join": 5}

# torch dtype -> hvdtpu::DataType (native/common.h; the codes of
# horovod_tpu/basics.py:32-33).
_DTYPES = {torch.uint8: 0, torch.int8: 1, torch.int32: 4, torch.int64: 5,
           torch.float16: 6, torch.float32: 7, torch.float64: 8,
           torch.bool: 9, torch.bfloat16: 10}

# hvdtpu::AllreduceAlgo (native/data_plane.h).
_ALLREDUCE_ALGOS = {name: code
                    for code, name in enumerate(ev.ALLREDUCE_ALGOS)}

# hvdtpu::CtrlMsg (native/core.cpp) and hvdtpu::ResponseType
# (native/message.h) of the copy: the JAX package's tags and the negotiated
# shutdown's. Python builds no control frame; these mirrors hold the copy's
# tags to one written-down table (scripts/check_invariants.py's
# ENUM-MIRROR, run over the copy by tests/test_torch_port_native_checks.py).
_CTRL_MSGS = {"hello": 1, "peers": 2, "ready": 3, "responses": 4, "join": 5,
              "need_full": 6, "params": 7, "clock": 8, "gradcheck": 9,
              "shutdown_req": 10, "shutdown_ack": 11, "shutdown_fin": 12}
_RESPONSE_TYPES = {"ok": 0, "error": 1, "join_done": 2, "shutdown": 3,
                   "clean_shutdown": 4}


def _library_path() -> str:
    """The core built from the port's own sources, compiled at the first
    call."""
    from .utils import native_build
    return str(native_build.build())


# --------------------------------------------------------------------------
# C-API registration table
# --------------------------------------------------------------------------
# Declarative mirror of the ``extern "C"`` block in native/core.cpp: the
# one place the ctypes signatures are written down.
# tests/test_torch_port_native_abi.py holds it against the port's core.cpp.
# Entry format: (symbol, restype, argtypes). The library is always built
# from the sources beside it, so every entry is exported.

_I64P = ctypes.POINTER(ctypes.c_longlong)
_I32P = ctypes.POINTER(ctypes.c_int)

_C_API = (
    ("hvdtpu_create", ctypes.c_void_p,
     [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
      ctypes.c_double, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
      ctypes.c_double]),
    ("hvdtpu_start", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_shutdown", None, [ctypes.c_void_p]),
    ("hvdtpu_destroy", None, [ctypes.c_void_p]),
    ("hvdtpu_enqueue", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, _I64P, ctypes.c_int, ctypes.c_void_p, ctypes.c_double,
      ctypes.c_double, ctypes.c_int, _I32P, ctypes.c_int, ctypes.c_char_p,
      ctypes.c_int]),
    ("hvdtpu_enqueue_reducescatter", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _I64P,
      ctypes.c_int, ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
      ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_enqueue_allgather", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, _I64P, ctypes.c_int,
      ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_enqueue_broadcast", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, _I64P, ctypes.c_int,
      ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_enqueue_alltoall", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, _I64P, ctypes.c_int,
      ctypes.c_void_p, _I32P, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_group_begin", None, [ctypes.c_void_p]),
    ("hvdtpu_group_end", None, [ctypes.c_void_p]),
    ("hvdtpu_wait", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_poll", ctypes.c_int, [ctypes.c_void_p, ctypes.c_longlong]),
    ("hvdtpu_result_bytes", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_longlong]),
    ("hvdtpu_copy_result", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
      ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_join", ctypes.c_longlong, [ctypes.c_void_p]),
    ("hvdtpu_set_cache_capacity", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong]),
    ("hvdtpu_hmac_hex", ctypes.c_int,
     [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_set_secret", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_char_p]),
    ("hvdtpu_set_allreduce_tuning", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]),
    ("hvdtpu_set_scale_tuning", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]),
    ("hvdtpu_set_bcast_tuning", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong]),
    ("hvdtpu_set_optimizer_state_bytes", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong]),
    ("hvdtpu_set_transport", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]),
    ("hvdtpu_set_transport_ext", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]),
    ("hvdtpu_set_stall_shutdown", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_double]),
    ("hvdtpu_set_failure_detection", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_double]),
    ("hvdtpu_set_chaos", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
      ctypes.c_longlong, ctypes.c_int]),
    ("hvdtpu_observe_recovery", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_double]),
    ("hvdtpu_set_compression", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p]),
    ("hvdtpu_wire_stats", None, [ctypes.c_void_p, _I64P, _I64P]),
    ("hvdtpu_metrics_dump", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]),
    ("hvdtpu_set_flightrec", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p]),
    ("hvdtpu_flightrec_dump", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_char_p]),
    ("hvdtpu_set_perfstats", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong,
      ctypes.c_char_p]),
    ("hvdtpu_set_profiler", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
      ctypes.c_int, ctypes.c_char_p]),
    ("hvdtpu_profiler_start", ctypes.c_int, [ctypes.c_void_p]),
    ("hvdtpu_profiler_stop", ctypes.c_int, [ctypes.c_void_p]),
    ("hvdtpu_profiler_running", ctypes.c_int, [ctypes.c_void_p]),
    ("hvdtpu_profiler_snapshot", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]),
    ("hvdtpu_set_gradstats", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
      ctypes.c_char_p]),
    ("hvdtpu_gradstats_snapshot", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]),
    ("hvdtpu_perfstats_snapshot", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]),
    ("hvdtpu_flightrec_snapshot", ctypes.c_longlong,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]),
    ("hvdtpu_wire_compressed_bytes", ctypes.c_longlong,
     [ctypes.c_int, ctypes.c_longlong]),
    ("hvdtpu_wire_compress", ctypes.c_int,
     [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
      ctypes.c_void_p]),
    ("hvdtpu_wire_decompress", ctypes.c_int,
     [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]),
    ("hvdtpu_set_autotune", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_double]),
    ("hvdtpu_start_timeline", None,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
    ("hvdtpu_stop_timeline", None, [ctypes.c_void_p]),
    ("hvdtpu_set_trace", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double]),
    ("hvdtpu_start_trace", None,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong]),
    ("hvdtpu_clock_offset", None, [ctypes.c_void_p, _I64P, _I64P]),
    ("hvdtpu_cycle_time_ms", ctypes.c_double, [ctypes.c_void_p]),
    ("hvdtpu_fusion_threshold", ctypes.c_longlong, [ctypes.c_void_p]),
)


def register_c_api(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Apply the _C_API table to a freshly dlopen'd core library; a
    missing symbol is an AttributeError."""
    for symbol, restype, argtypes in _C_API:
        fn = getattr(lib, symbol)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load_lib() -> ctypes.CDLL:
    return register_c_api(ctypes.CDLL(_library_path()))


_lib: Optional[ctypes.CDLL] = None


def _raise_for(message: str):
    """Map a native error message onto the exception hierarchy
    (reference error strings: controller.cc ConstructResponse)."""
    if "already pending" in message:
        raise DuplicateNameError(message)
    if "Mismatched data types" in message:
        raise TensorDtypeMismatchError(message)
    if "Mismatched" in message and ("shape" in message
                                    or "tensor ranks" in message):
        raise TensorShapeMismatchError(message)
    raise HvdTpuInternalError(message)


def _host_view(t: torch.Tensor):
    """(contiguous CPU tensor, DataType code) of what the core reads."""
    if t.device.type != "cpu":
        raise ValueError(f"the native core reads host memory; stage the "
                         f"{t.device} tensor to the CPU first")
    if t.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype for native collective: "
                        f"{str(t.dtype).replace('torch.', '')}")
    return t.detach().contiguous(), _DTYPES[t.dtype]


class NativeCore:
    """One process's handle to the native runtime (process mode)."""

    def __init__(self, rank: int, size: int, local_rank: int = 0,
                 local_size: int = 1, cross_rank: Optional[int] = None,
                 cross_size: Optional[int] = None,
                 coord_host: Optional[str] = None,
                 coord_port: Optional[int] = None):
        global _lib
        if _lib is None:
            _lib = _load_lib()
        self._lib = _lib
        self.rank = rank
        self.size = size
        if coord_host is None:
            coord_host = ev.get_str(ev.HVDTPU_CONTROLLER_ADDR, "127.0.0.1")
        if coord_port is None:
            coord_port = ev.get_int(ev.HVDTPU_CONTROLLER_PORT, 29500)
        my_host = ev.get_str(ev.HVDTPU_HOSTNAME, "127.0.0.1")
        cycle_ms = ev.get_float(ev.HVDTPU_CYCLE_TIME, 1.0)
        fusion = ev.get_int(ev.HVDTPU_FUSION_THRESHOLD, 64 * 1024 * 1024)
        # Distributed tracing (docs/tracing.md): HVDTPU_TRACE names a
        # DIRECTORY — each rank writes trace.<rank>.json there with per-hop
        # child spans sampled every HVDTPU_TRACE_SAMPLE ops. An explicit
        # HVDTPU_TIMELINE wins for the output path (the spans then ride the
        # timeline file).
        trace_dir = ev.get_str(ev.HVDTPU_TRACE, "") or ""
        # "Configured" means the user expressed a sampling choice (the env
        # var, or tracing enabled at launch); a later hvd.start_trace with
        # sample=None falls back to the documented default only when they
        # did NOT (an explicit HVDTPU_TRACE_SAMPLE=0 stays op-phases-only).
        self._trace_sample_configured = (
            ev.get_str(ev.HVDTPU_TRACE_SAMPLE) is not None or bool(trace_dir))
        trace_sample = ev.get_int(
            ev.HVDTPU_TRACE_SAMPLE,
            ev.DEFAULT_TRACE_SAMPLE if trace_dir else 0)
        if trace_sample < 0:
            raise ValueError(
                f"{ev.HVDTPU_TRACE_SAMPLE} must be >= 0 (every Nth op; "
                f"0 disables hop spans), got {trace_sample}")
        timeline = ev.get_str(ev.HVDTPU_TIMELINE, "") or ""
        if trace_dir and not timeline:
            os.makedirs(trace_dir, exist_ok=True)
            timeline = os.path.join(trace_dir, f"trace.{rank}.json")
        mark_cycles = ev.get_bool(ev.HVDTPU_TIMELINE_MARK_CYCLES)
        stall = ev.get_float(ev.HVDTPU_STALL_CHECK_TIME_SECONDS, 60.0)
        if ev.get_bool(ev.HVDTPU_STALL_CHECK_DISABLE):
            stall = 1e18
        self._core = self._lib.hvdtpu_create(
            rank, size, local_rank, local_size,
            cross_rank if cross_rank is not None else rank,
            cross_size if cross_size is not None else size,
            coord_host.encode(), coord_port, my_host.encode(), cycle_ms,
            fusion, timeline.encode(), int(mark_cycles), stall)
        # Distributed tracing: every-Nth-op hop-span sampling + the
        # control-plane clock-refresh period (docs/tracing.md).
        clock_sync = ev.get_float(ev.HVDTPU_TRACE_CLOCK_SYNC_SECONDS, 30.0)
        if clock_sync <= 0:
            raise ValueError(
                f"{ev.HVDTPU_TRACE_CLOCK_SYNC_SECONDS} must be > 0 seconds, "
                f"got {clock_sync}")
        self._lib.hvdtpu_set_trace(self._core, trace_sample, clock_sync)
        # Always-on flight recorder (docs/fault-tolerance.md "Post-mortem
        # debugging"): in-memory ring of binary phase records, dumped to
        # HVDTPU_FLIGHTREC_DIR/flightrec.<rank>.bin on abort/stall/fatal
        # signal. On by default; the ring alone is ~160 KB and costs five
        # relaxed atomic stores per hop.
        fr_events = ev.get_int(ev.HVDTPU_FLIGHTREC_EVENTS,
                               ev.DEFAULT_FLIGHTREC_EVENTS)
        # Upper bound: 16M records = 640 MB of ring — far past any forensic
        # need, and a fat-fingered value must fail naming the knob instead
        # of aborting every worker in a native bad_alloc. (Values 1..63 are
        # raised to the native floor of 64; see docs/envvars.md.)
        if fr_events < 0 or fr_events > ev.MAX_FLIGHTREC_EVENTS:
            raise ValueError(
                f"{ev.HVDTPU_FLIGHTREC_EVENTS} must be 0.."
                f"{ev.MAX_FLIGHTREC_EVENTS} records, got {fr_events}")
        if not ev.get_bool(ev.HVDTPU_FLIGHTREC, default=True):
            fr_events = 0
        fr_dir = ev.get_str(ev.HVDTPU_FLIGHTREC_DIR, "") or ""
        if fr_dir and fr_events > 0:
            # Absolute: the native side precomposes the dump path once and
            # opens it at failure time — a training script that chdir()s
            # after init must not scatter dumps across working dirs.
            fr_dir = os.path.abspath(fr_dir)
            os.makedirs(fr_dir, exist_ok=True)
        self._lib.hvdtpu_set_flightrec(self._core, fr_events,
                                       fr_dir.encode())
        # Always-on perf attribution (docs/observability.md): streaming
        # per-key baselines + the slowdown sentry. The profile path is
        # absolute for the same chdir() reason as the flight-recorder dir.
        perf_pct = ev.get_float(ev.HVDTPU_PERF_SLOWDOWN_PCT,
                                ev.DEFAULT_PERF_SLOWDOWN_PCT)
        if perf_pct < 0:
            raise ValueError(
                f"{ev.HVDTPU_PERF_SLOWDOWN_PCT} must be >= 0 percent "
                f"(0 disables the sentry), got {perf_pct}")
        perf_min = ev.get_int(ev.HVDTPU_PERF_MIN_SAMPLES,
                              ev.DEFAULT_PERF_MIN_SAMPLES)
        if perf_min < 1:
            raise ValueError(
                f"{ev.HVDTPU_PERF_MIN_SAMPLES} must be >= 1 sample, "
                f"got {perf_min}")
        perf_on = ev.get_bool(ev.HVDTPU_PERFSTATS, default=True)
        profile_path = ""
        profile_dir = ev.get_str(ev.HVDTPU_PERF_PROFILE_DIR, "") or ""
        if profile_dir and perf_on:
            profile_dir = os.path.abspath(profile_dir)
            os.makedirs(profile_dir, exist_ok=True)
            profile_path = os.path.join(profile_dir,
                                        f"perf_profile.{rank}.json")
        self._lib.hvdtpu_set_perfstats(self._core, int(perf_on), perf_pct,
                                       perf_min, profile_path.encode())
        # Numerical-health observability (docs/numerics.md): gradient
        # moments + quantization quality + the cross-rank divergence
        # probe, plus the NaN/Inf sentinel policy. Profile path absolute
        # for the same chdir() reason as the dirs above.
        grad_on = ev.get_bool(ev.HVDTPU_GRADSTATS, default=True)
        nancheck = (ev.get_str(ev.HVDTPU_NANCHECK, "warn") or
                    "warn").strip().lower()
        if nancheck not in ev.NAN_POLICIES:
            raise ValueError(
                f"{ev.HVDTPU_NANCHECK} must be one of "
                f"{sorted(ev.NAN_POLICIES)}, got {nancheck!r}")
        gradcheck = ev.get_int(ev.HVDTPU_GRADCHECK_SAMPLE,
                               ev.DEFAULT_GRADCHECK_SAMPLE)
        if gradcheck < 0:
            raise ValueError(
                f"{ev.HVDTPU_GRADCHECK_SAMPLE} must be >= 0 (every Nth "
                f"op; 0 disables the divergence probe), got {gradcheck}")
        grad_profile = ""
        grad_dir = ev.get_str(ev.HVDTPU_GRAD_PROFILE_DIR, "") or ""
        if grad_dir and grad_on:
            grad_dir = os.path.abspath(grad_dir)
            os.makedirs(grad_dir, exist_ok=True)
            grad_profile = os.path.join(grad_dir,
                                        f"grad_profile.{rank}.json")
        self._lib.hvdtpu_set_gradstats(
            self._core, int(grad_on), ev.NAN_POLICIES[nancheck], gradcheck,
            grad_profile.encode())
        # In-process sampling profiler (docs/profiling.md): armed by
        # default, sampling only while a window runs. HVDTPU_PROF_DIR (set
        # by `hvdrun --profile`) runs the window for the whole job and
        # writes prof.<rank>.folded at shutdown — absolute for the same
        # chdir() reason as the dirs above.
        prof_on = ev.get_bool(ev.HVDTPU_PROF, default=True)
        prof_hz = ev.get_int(ev.HVDTPU_PROF_HZ, ev.DEFAULT_PROF_HZ)
        if prof_hz < 1 or prof_hz > ev.MAX_PROF_HZ:
            raise ValueError(
                f"{ev.HVDTPU_PROF_HZ} must be 1..{ev.MAX_PROF_HZ} Hz, "
                f"got {prof_hz}")
        prof_clock = (ev.get_str(ev.HVDTPU_PROF_CLOCK, "cpu") or
                      "cpu").strip().lower()
        if prof_clock not in ev.PROF_CLOCK_MODES:
            raise ValueError(
                f"{ev.HVDTPU_PROF_CLOCK} must be one of "
                f"{sorted(ev.PROF_CLOCK_MODES)}, got {prof_clock!r}")
        prof_folded = ""
        prof_dir = ev.get_str(ev.HVDTPU_PROF_DIR, "") or ""
        if prof_dir and prof_on:
            prof_dir = os.path.abspath(prof_dir)
            os.makedirs(prof_dir, exist_ok=True)
            prof_folded = os.path.join(prof_dir, f"prof.{rank}.folded")
        self._lib.hvdtpu_set_profiler(
            self._core, int(prof_on), prof_hz, 0,
            ev.PROF_CLOCK_MODES[prof_clock], prof_folded.encode())
        # Response cache (reference: HOROVOD_CACHE_CAPACITY; 0 disables).
        self._lib.hvdtpu_set_cache_capacity(
            self._core, ev.get_int(ev.HVDTPU_CACHE_CAPACITY, 1024))
        secret = ev.get_str(ev.HVDTPU_SECRET, "")
        if secret:
            # Authenticated control plane (reference: secret.py shared key).
            self._lib.hvdtpu_set_secret(self._core, secret.encode())
        # Stall force-shutdown (reference: HOROVOD_STALL_SHUTDOWN_TIME_SECONDS
        # — the reference defaults this to 0/disabled, which left the
        # escalation dead code; here the default is AUTO (-1): 10x the
        # warning threshold, so a wedged world always breaks eventually.
        # An explicit 0 still disables).
        self._lib.hvdtpu_set_stall_shutdown(
            self._core,
            ev.get_float(ev.HVDTPU_STALL_SHUTDOWN_TIME_SECONDS, -1.0))
        # Fast failure detection (docs/fault-tolerance.md): how quickly a
        # dead/hung peer breaks in-flight transport ops, and how long mesh
        # form-up may take before failing over to re-rendezvous.
        self._lib.hvdtpu_set_failure_detection(
            self._core,
            ev.get_int(ev.HVDTPU_FAILURE_DETECT_MS, 500),
            ev.get_float(ev.HVDTPU_READ_DEADLINE_SECONDS, 10.0),
            ev.get_float(ev.HVDTPU_FORMUP_TIMEOUT_SECONDS, 60.0))
        # Fault injection (HVDTPU_CHAOS; horovod_tpu/chaos.py owns the
        # grammar, including rank targeting and the elastic one-shot
        # marker). A malformed spec fails init loudly on every rank.
        from .chaos import armed_chaos
        chaos = armed_chaos(rank)
        if chaos is not None:
            self._lib.hvdtpu_set_chaos(
                self._core, chaos.action, chaos.op_index, chaos.hop_index,
                chaos.delay_ms, chaos.peer)
        # Allreduce algorithm menu (reference fork: ring/scatter-allgather/
        # parameter-server/tree selection). auto = size-adaptive: recursive
        # doubling at or below the (autotuned) crossover, then
        # scatter-allgather or the pipelined ring above it depending on the
        # group size vs the SA_GROUP floor.
        algo = (ev.get_str(ev.HVDTPU_ALLREDUCE_ALGO, "auto") or
                "auto").strip().lower()
        if algo not in _ALLREDUCE_ALGOS:
            raise ValueError(
                f"{ev.HVDTPU_ALLREDUCE_ALGO} must be one of "
                f"{list(ev.ALLREDUCE_ALGOS)}, got {algo!r}")
        self._lib.hvdtpu_set_allreduce_tuning(
            self._core, _ALLREDUCE_ALGOS[algo],
            ev.get_int(ev.HVDTPU_ALLREDUCE_CROSSOVER, 0),
            ev.get_int(ev.HVDTPU_ALLREDUCE_SEGMENT_BYTES, 0))
        # Scale-out knobs: AUTO's scatter-allgather group floor and the
        # control-plane frame batching toggle (native/core.cpp CtrlOutbox).
        sa_group = ev.get_int(ev.HVDTPU_ALLREDUCE_SA_GROUP, -1)
        ctrl_batch = int(ev.get_bool(ev.HVDTPU_CTRL_BATCH, default=True))
        self._lib.hvdtpu_set_scale_tuning(self._core, sa_group, ctrl_batch)
        # Broadcast schedule floor (native/data_plane.h): payloads at or
        # below this ride the flat root-fanout, larger ones the binomial
        # tree. < 0 keeps the native default.
        self._lib.hvdtpu_set_bcast_tuning(
            self._core, ev.get_int(ev.HVDTPU_BCAST_FLAT_MAX, -1))
        # Transport subsystem (native/transport.h): same-host rank pairs ride
        # POSIX shared-memory ring lanes unless HVDTPU_SHM=0; the two-level
        # allreduce (HVDTPU_ALLREDUCE_HIER) defaults to autotuner-owned auto.
        hier = (ev.get_str(ev.HVDTPU_ALLREDUCE_HIER, "auto") or
                "auto").strip().lower()
        if hier not in ev.ALLREDUCE_HIER_MODES:
            raise ValueError(
                f"{ev.HVDTPU_ALLREDUCE_HIER} must be one of "
                f"{sorted(set(ev.ALLREDUCE_HIER_MODES) - {''})}, got {hier!r}")
        self._lib.hvdtpu_set_transport(
            self._core, int(ev.get_bool(ev.HVDTPU_SHM, default=True)),
            ev.get_int(ev.HVDTPU_SHM_RING_BYTES, 0),
            ev.ALLREDUCE_HIER_MODES[hier])
        # Zero-copy transport lane (docs/collectives.md "Zero-copy TCP
        # lane"): MSG_ZEROCOPY/io_uring TCP sends (runtime-probed per lane,
        # copy-path fallback), NUMA placement of the shm rings, and the
        # futex-doorbell coalescing window.
        zc = (ev.get_str(ev.HVDTPU_TCP_ZEROCOPY, "auto") or
              "auto").strip().lower()
        if zc not in ev.TCP_ZEROCOPY_MODES:
            raise ValueError(
                f"{ev.HVDTPU_TCP_ZEROCOPY} must be one of "
                f"{sorted(ev.TCP_ZEROCOPY_MODES)}, got {zc!r}")
        numa = (ev.get_str(ev.HVDTPU_SHM_NUMA, "auto") or
                "auto").strip().lower()
        if numa not in ev.SHM_NUMA_MODES:
            raise ValueError(
                f"{ev.HVDTPU_SHM_NUMA} must be one of "
                f"{sorted(ev.SHM_NUMA_MODES)}, got {numa!r}")
        doorbell = ev.get_int(ev.HVDTPU_DOORBELL_BATCH, 0)
        if doorbell < 0:
            raise ValueError(
                f"{ev.HVDTPU_DOORBELL_BATCH} must be >= 0 bytes, got "
                f"{doorbell}")
        self._lib.hvdtpu_set_transport_ext(
            self._core, ev.TCP_ZEROCOPY_MODES[zc], ev.SHM_NUMA_MODES[numa],
            doorbell)
        # Wire compression (native/compressed.{h,cpp}): quantize allreduce
        # payloads on the process-mode wire. HVDTPU_COMPRESSION doubles as
        # the selector (wire modes none/fp16/int8/int4/auto; "maxmin" rides
        # its bits knob; JAX-only compressor names keep the wire dense).
        wire_mode = ev.get_wire_compression(
            ev.get_str(ev.HVDTPU_COMPRESSION, "none") or "none",
            bits=ev.get_int(ev.HVDTPU_QUANTIZATION_BITS, 4))
        if wire_mode == ev.WIRE_COMPRESSION_MODES["auto"] and \
                not ev.get_bool(ev.HVDTPU_AUTOTUNE):
            # Without the autotuner nothing ever picks a mode: "auto"
            # silently behaves like "none" — say so instead.
            log.warning(
                "%s=auto has no effect without %s=1 (the Bayesian autotuner "
                "owns the choice); the wire stays uncompressed",
                ev.HVDTPU_COMPRESSION, ev.HVDTPU_AUTOTUNE)
        skip = ev.get_str(ev.HVDTPU_COMPRESSION_SKIP_REGEX,
                          ev.DEFAULT_COMPRESSION_SKIP_REGEX) or ""
        try:
            re.compile(skip)
        except re.error as exc:
            raise ValueError(
                f"{ev.HVDTPU_COMPRESSION_SKIP_REGEX} is not a valid regex: "
                f"{exc}")
        min_bytes = ev.get_int(ev.HVDTPU_COMPRESSION_MIN_BYTES,
                               ev.DEFAULT_COMPRESSION_MIN_BYTES)
        if min_bytes < 0:
            raise ValueError(
                f"{ev.HVDTPU_COMPRESSION_MIN_BYTES} must be >= 0, got "
                f"{min_bytes}")
        self._lib.hvdtpu_set_compression(self._core, wire_mode, min_bytes,
                                         skip.encode())
        # Autotune (reference: HOROVOD_AUTOTUNE + HOROVOD_AUTOTUNE_* knobs,
        # operations.cc:474-532).
        if ev.get_bool(ev.HVDTPU_AUTOTUNE):
            self._lib.hvdtpu_set_autotune(
                self._core, 1,
                (ev.get_str(ev.HVDTPU_AUTOTUNE_LOG, "") or "").encode(),
                ev.get_int(ev.HVDTPU_AUTOTUNE_WARMUP_SAMPLES, 3),
                ev.get_int(ev.HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE, 50),
                ev.get_int(ev.HVDTPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES, 30),
                ev.get_float(ev.HVDTPU_AUTOTUNE_GAUSSIAN_PROCESS_NOISE, 0.2))
        self._started = False
        # Inputs pinned until their async op completes (the native core reads
        # the caller's buffer zero-copy).
        self._inflight = {}

    def start(self) -> None:
        err = ctypes.create_string_buffer(1024)
        if self._lib.hvdtpu_start(self._core, err, len(err)) != 0:
            raise HvdTpuInternalError(
                f"native core start failed: {err.value.decode()}")
        self._started = True

    def shutdown(self) -> None:
        if self._core:
            self._lib.hvdtpu_shutdown(self._core)
            self._lib.hvdtpu_destroy(self._core)
            self._core = None

    def wire_stats(self) -> tuple:
        """(raw_bytes, wire_bytes) cumulative allreduce payload accounting
        for this rank: what would have been sent uncompressed vs what the
        data plane actually sent (equal when wire compression is off).
        Thin shim over the native metrics registry's
        ``hvdtpu_allreduce_{raw,wire}_bytes_total`` counters — the same
        values the ``/metrics`` endpoint serves."""
        raw = ctypes.c_longlong(0)
        wire = ctypes.c_longlong(0)
        self._lib.hvdtpu_wire_stats(self._core, ctypes.byref(raw),
                                    ctypes.byref(wire))
        return raw.value, wire.value

    def set_optimizer_state_bytes(self, nbytes: int) -> None:
        """Publish this rank's resident optimizer-state footprint to the
        native ``hvdtpu_optimizer_state_bytes`` gauge (docs/optimizer.md
        "Sharded optimizer state") so ``/metrics`` can attest the ZeRO-1
        1/world memory claim next to the RSS gauges."""
        if self._core:
            self._lib.hvdtpu_set_optimizer_state_bytes(self._core,
                                                       int(nbytes))

    def _probe_then_copy(self, cfunc) -> bytes:
        """Drain a probe-then-copy C API (``cfunc(core, NULL, 0)`` returns
        the full size; a second call copies): loop in case the payload
        grew between the two calls. b"" when the core is shut down (an
        HTTP handler thread racing teardown gets empty, not a dead
        pointer) or the source is disabled."""
        core = self._core
        if not core:
            return b""
        need = cfunc(core, None, 0)
        while need > 0:
            buf = ctypes.create_string_buffer(int(need))
            got = cfunc(core, buf, len(buf))
            if got <= len(buf):
                return buf.raw[:got]
            need = got
        return b""

    def metrics_dump(self) -> str:
        """Prometheus text exposition of the native metrics registry
        (counters, gauges, histograms instrumented throughout the
        background loop and data plane; see docs/metrics.md)."""
        return self._probe_then_copy(self._lib.hvdtpu_metrics_dump).decode()

    def observe_recovery(self, seconds: float) -> None:
        """Record one completed elastic recovery: failure detection to
        successful re-initialization took ``seconds``. Observed against
        THIS (post-recovery) core's registry — ``hvdtpu_recovery_seconds``
        plus a ``hvdtpu_failures_detected_total`` increment — so
        ``hvd.metrics()`` after a recovery shows the whole episode
        (docs/fault-tolerance.md)."""
        if self._core:
            self._lib.hvdtpu_observe_recovery(self._core, float(seconds))

    # -- collectives -------------------------------------------------------

    def group_begin(self) -> None:
        """Open a grouped-collective window (docs/collectives.md "Grouped
        enqueue"): until :meth:`group_end`, enqueued ops park in the
        pending queue without being drained by the background cycle, so
        the whole group negotiates in ONE READY/RESPONSES round (and
        same-op/dtype lists fuse into one execution)."""
        if self._core:
            self._lib.hvdtpu_group_begin(self._core)

    def group_end(self) -> None:
        """Close the grouped window and wake the background loop; the
        parked group drains into the next cycle together."""
        if self._core:
            self._lib.hvdtpu_group_end(self._core)

    def enqueue(self, kind: str, name: str, tensor: torch.Tensor,
                op: int = 1, prescale: float = 1.0, postscale: float = 1.0,
                root_rank: int = 0, splits=None) -> int:
        """Start a collective on a CPU tensor and return its handle. The
        core reads the tensor's memory from its own thread, so the tensor
        is kept alive, and must not be written, until :meth:`wait`."""
        arr, dtype_code = _host_view(tensor)
        shape = (ctypes.c_longlong * arr.dim())(*arr.shape)
        err = ctypes.create_string_buffer(1024)
        if splits is not None:
            splits = torch.as_tensor(splits, dtype=torch.int32).reshape(
                -1).contiguous()
            splits_ptr = ctypes.cast(splits.data_ptr(),
                                     ctypes.POINTER(ctypes.c_int))
            nsplits = splits.numel()
        else:
            splits_ptr = None
            nsplits = 0
        data = ctypes.c_void_p(arr.data_ptr())
        # Each kind's narrow entry point where it takes every argument
        # given; the generic hvdtpu_enqueue for allreduce, join and the
        # combinations the narrow ones lack.
        plain = prescale == 1.0 and postscale == 1.0
        if kind == "reducescatter" and splits is None and root_rank == 0:
            handle = self._lib.hvdtpu_enqueue_reducescatter(
                self._core, name.encode(), op, dtype_code, shape, arr.dim(),
                data, prescale, postscale, err, len(err))
        elif (kind == "allgather" and splits is None and root_rank == 0
                and plain):
            handle = self._lib.hvdtpu_enqueue_allgather(
                self._core, name.encode(), dtype_code, shape, arr.dim(),
                data, err, len(err))
        elif kind == "broadcast" and splits is None and plain:
            handle = self._lib.hvdtpu_enqueue_broadcast(
                self._core, name.encode(), dtype_code, shape, arr.dim(),
                data, root_rank, err, len(err))
        elif kind == "alltoall" and root_rank == 0 and plain:
            handle = self._lib.hvdtpu_enqueue_alltoall(
                self._core, name.encode(), dtype_code, shape, arr.dim(),
                data, splits_ptr, nsplits, err, len(err))
        else:
            handle = self._lib.hvdtpu_enqueue(
                self._core, name.encode(), _OP_TYPES[kind], op, dtype_code,
                shape, arr.dim(), data, prescale, postscale, root_rank,
                splits_ptr, nsplits, err, len(err))
        if handle < 0:
            _raise_for(err.value.decode())
        self._inflight[handle] = arr
        return int(handle)

    def wait(self, handle: int, out_dtype: torch.dtype, row_shape,
             pin: bool = False) -> torch.Tensor:
        """Wait for a collective and return its result as a new CPU tensor
        of ``out_dtype``: ``[rows, *row_shape]`` when the result's size is
        a whole number of rows, else flat. ``pin`` allocates it in pinned
        memory through PyTorch's caching host allocator, so a
        ``non_blocking`` copy to the card may read it after it is
        dropped."""
        self._require_core()
        err = ctypes.create_string_buffer(2048)
        rc = self._lib.hvdtpu_wait(self._core, handle, err, len(err))
        self._inflight.pop(handle, None)
        if rc != 0:
            # Release native-side state for the failed handle.
            self._lib.hvdtpu_copy_result(self._core, handle, None, 0, None, 0)
            _raise_for(err.value.decode())
        nbytes = self._lib.hvdtpu_result_bytes(self._core, handle)
        itemsize = torch.empty((), dtype=out_dtype).element_size()
        row_elems = 1
        for d in row_shape:
            row_elems *= int(d)
        total = nbytes // itemsize
        if row_elems and total % row_elems == 0 and row_shape:
            shape = (total // row_elems,) + tuple(row_shape)
        else:
            shape = (total,)
        out = torch.empty(shape, dtype=out_dtype, pin_memory=pin)
        rc = self._lib.hvdtpu_copy_result(
            self._core, handle, ctypes.c_void_p(out.data_ptr()),
            out.numel() * itemsize, err, len(err))
        if rc != 0:
            _raise_for(err.value.decode())
        return out

    def poll(self, handle: int) -> bool:
        self._require_core()
        return bool(self._lib.hvdtpu_poll(self._core, handle))

    def _require_core(self) -> None:
        """A handle of a core that was shut down (a world an elastic reset
        left behind) is an error, not a call on a freed core."""
        if not self._core:
            raise HvdTpuInternalError(
                "the native core this collective ran on was shut down")

    def collective(self, kind: str, name: str, tensor: torch.Tensor,
                   op: int = 1, prescale: float = 1.0,
                   postscale: float = 1.0, root_rank: int = 0,
                   splits=None) -> torch.Tensor:
        """Synchronous collective on a CPU tensor: enqueue and wait.

        allreduce and broadcast keep the input's shape; allgather
        concatenates along dim 0 (ranks may differ there); alltoall returns
        the rows received; reducescatter returns this rank's part of dim 0.
        """
        handle = self.enqueue(kind, name, tensor, op=op, prescale=prescale,
                              postscale=postscale, root_rank=root_rank,
                              splits=splits)
        row_shape = tuple(tensor.shape[1:]) if tensor.dim() > 0 else ()
        out = self.wait(handle, tensor.dtype, row_shape)
        if kind in ("allreduce", "broadcast"):
            out = out.reshape(tensor.shape)
        return out

    # -- timeline / introspection -----------------------------------------

    def start_timeline(self, path: str, mark_cycles: bool = False) -> None:
        """Begin writing a Chrome-trace timeline at runtime (reference:
        ``horovod_start_timeline``, operations.cc:735)."""
        self._lib.hvdtpu_start_timeline(self._core, path.encode(),
                                        int(mark_cycles))

    def stop_timeline(self) -> None:
        """Stop a running timeline (reference: ``horovod_stop_timeline``,
        operations.cc:780)."""
        self._lib.hvdtpu_stop_timeline(self._core)

    def start_trace(self, path: str, sample: Optional[int] = None,
                    mark_cycles: bool = False) -> None:
        """Begin a distributed trace at runtime: a timeline whose per-hop
        child spans are sampled every ``sample`` ops (None keeps the
        configured ``HVDTPU_TRACE_SAMPLE`` rate; the file also carries the
        clock metadata ``python -m horovod_tpu_torch.trace_analysis``
        merges on). See
        docs/tracing.md."""
        if sample is not None and sample < 0:
            raise ValueError(f"sample must be >= 0, got {sample}")
        if sample is None and not self._trace_sample_configured:
            # Tracing was never configured at init (cfg rate is 0): a
            # runtime start_trace must still produce hop spans by default.
            sample = ev.DEFAULT_TRACE_SAMPLE
        self._lib.hvdtpu_start_trace(self._core, path.encode(),
                                     int(mark_cycles),
                                     -1 if sample is None else int(sample))

    def stop_trace(self) -> None:
        """Stop a running distributed trace (== stop_timeline)."""
        self._lib.hvdtpu_stop_timeline(self._core)

    def clock_offset(self) -> tuple:
        """(offset_us, err_us): this rank's steady-clock offset vs rank 0
        with its error bound, from the form-up ping-pong sync (refreshed
        periodically while tracing). err_us < 0 = never synced."""
        off = ctypes.c_longlong(0)
        err = ctypes.c_longlong(-1)
        self._lib.hvdtpu_clock_offset(self._core, ctypes.byref(off),
                                      ctypes.byref(err))
        return off.value, err.value

    def perfstats_snapshot(self) -> bytes:
        """Keyed perf-baseline snapshot as JSON bytes (decode with
        :mod:`horovod_tpu_torch.perfstats` / ``json.loads``): per-{tensor-set,
        algo, transport, hier, compression, op} EWMA + p50/p99 of op wall time
        and the wait/wire/reduce/codec phase buckets, plus anomaly counts.
        The same payload the ``/perfz`` endpoint serves. ``b""`` when the
        core is shut down."""
        return self._probe_then_copy(self._lib.hvdtpu_perfstats_snapshot)

    def gradstats_snapshot(self) -> bytes:
        """Keyed numerical-health snapshot as JSON bytes (decode with
        :mod:`horovod_tpu_torch.gradstats` / ``json.loads``): per-tensor
        gradient norms/absmax/NaN counts, per-key quantization MSE/SNR +
        error-feedback residual norms, and the divergence-probe totals.
        The same payload the ``/gradz`` endpoint serves. ``b""`` when the
        core is shut down."""
        return self._probe_then_copy(self._lib.hvdtpu_gradstats_snapshot)

    def profiler_start(self) -> None:
        """Open a sampling window (docs/profiling.md): clears the sample
        ring and arms every registered thread's SIGPROF timer. No-op when
        ``HVDTPU_PROF=0``. Idempotent."""
        if self._core:
            self._lib.hvdtpu_profiler_start(self._core)

    def profiler_stop(self) -> None:
        """Close the sampling window (timers disarmed; the ring keeps the
        window's samples for :meth:`profiler_snapshot`). Idempotent."""
        if self._core:
            self._lib.hvdtpu_profiler_stop(self._core)

    def profiler_running(self) -> bool:
        """True while a sampling window is open."""
        return bool(self._core and
                    self._lib.hvdtpu_profiler_running(self._core))

    def profiler_snapshot(self) -> bytes:
        """Folded-stacks JSON bytes (decode with
        :mod:`horovod_tpu_torch.profiler` / ``json.loads``): aggregated
        {phase, op, frames} -> count, dladdr-symbolized at snapshot time.
        The same payload the ``/profz`` endpoint serves. ``b""`` when the
        core is shut down."""
        return self._probe_then_copy(self._lib.hvdtpu_profiler_snapshot)

    def flightrec_snapshot(self) -> bytes:
        """Serialized flight-recorder dump image (binary; decode with
        :mod:`horovod_tpu_torch.flightrec`): the in-flight op and last-N phase
        events of this rank, live. ``b""`` when the recorder is disabled
        or the core is shut down."""
        return self._probe_then_copy(self._lib.hvdtpu_flightrec_snapshot)

    def flightrec_dump(self, path: Optional[str] = None) -> bool:
        """On-demand flight-recorder dump to ``path`` (None = the
        configured ``HVDTPU_FLIGHTREC_DIR/flightrec.<rank>.bin``). Returns
        False when the recorder is disabled or no destination is known."""
        if not self._core:
            return False
        return self._lib.hvdtpu_flightrec_dump(
            self._core, path.encode() if path else None) == 0

    def cycle_time_ms(self) -> float:
        """Current (possibly autotuned) background cycle time."""
        return float(self._lib.hvdtpu_cycle_time_ms(self._core))

    def fusion_threshold(self) -> int:
        """Current (possibly autotuned) fusion threshold in bytes."""
        return int(self._lib.hvdtpu_fusion_threshold(self._core))

    def join(self) -> int:
        ret = int(self._lib.hvdtpu_join(self._core))
        if ret == -2:
            raise HvdTpuInternalError(
                "join barrier broken: a peer process failed before joining")
        return ret
