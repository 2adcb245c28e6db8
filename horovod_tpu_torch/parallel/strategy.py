"""Flat-or-hierarchical allreduce, chosen by measurement.

Counterpart of ``horovod_tpu/parallel/strategy.py``; reference: the
parameter manager tunes ``hierarchical_allreduce`` on or off as a
categorical parameter, synchronized from the coordinator
(``horovod/common/parameter_manager.h:186``, ``controller.cc:34``).

:func:`autotune_hierarchical` times both programs on the live mesh at each
message size (the flat one: one allreduce over both axes' group; the
hierarchical one: :func:`~horovod_tpu_torch.ops.collectives.
hierarchical_allreduce`) and records the faster. ``hierarchical=("auto",
inner, outer)`` on :func:`~horovod_tpu_torch.parallel.optimizer.
DistributedOptimizer` consults the table when the optimizer is built: the
nearest measured size in log space decides, and a mesh that was not
calibrated reduces flat. The table is keyed by the mesh's shape, so one
measured on another topology never governs this one; rank 0's timings are
broadcast before any choice is recorded, so every rank builds the same
program. ``$HVDTPU_AUTOTUNE_LOG`` keeps the table across runs. The
measurement is injectable (``measure(kind, nbytes, inner, outer, reps) ->
seconds``), which is how the decision logic is tested against bandwidth
models.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import runtime
from ..ops import collectives as C
from ..utils import envvars as ev
from ..utils import logging as log

# (inner_axis, outer_axis, mesh-shape signature) -> sorted list of
# (nbytes, "flat" | "hierarchical").
_decisions: Dict[Tuple, List[Tuple[int, str]]] = {}
_lock = threading.Lock()
_warned_uncalibrated = set()
_AUTOTUNE_LOG_ENV = ev.HVDTPU_AUTOTUNE_LOG
_env_loaded = False


def _mesh_key(inner_axis: str, outer_axis: str) -> Tuple:
    return (inner_axis, outer_axis,
            tuple(sorted(runtime.mesh_shape().items())))


def _key_to_str(key: Tuple) -> str:
    return json.dumps([key[0], key[1], [list(p) for p in key[2]]])


def _str_to_key(s: str) -> Tuple:
    inner, outer, shape = json.loads(s)
    return (inner, outer, tuple((a, int(n)) for a, n in shape))


def save_hierarchical_decisions(path: Optional[str] = None) -> Optional[str]:
    """Write the table to ``path`` (default ``$HVDTPU_AUTOTUNE_LOG``),
    merged with the tables of other meshes already there; returns the path,
    or None when there is none. Written to a temporary file and renamed, so
    a crash never leaves half a table."""
    path = path or ev.get_str(_AUTOTUNE_LOG_ENV)
    if not path:
        return None
    with _lock:
        tables = {_key_to_str(k): [[int(s), c] for s, c in v]
                  for k, v in _decisions.items()}
    if os.path.exists(path):
        try:
            with open(path) as f:
                on_disk = json.load(f).get("tables", {})
            tables = {**on_disk, **tables}
        except Exception as exc:
            log.warning("save_hierarchical_decisions: existing %r "
                        "unreadable (%s); overwriting", path, exc)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "tables": tables}, f, indent=1)
    os.replace(tmp, path)
    return path


def load_hierarchical_decisions(path: Optional[str] = None) -> int:
    """Merge the tables of ``path`` (default ``$HVDTPU_AUTOTUNE_LOG``) into
    this process's; returns how many mesh signatures were loaded."""
    path = path or ev.get_str(_AUTOTUNE_LOG_ENV)
    if not path or not os.path.exists(path):
        return 0
    with open(path) as f:
        payload = json.load(f)
    n = 0
    with _lock:
        for ks, table in payload.get("tables", {}).items():
            key = _str_to_key(ks)
            _decisions[key] = [(int(s), str(c)) for s, c in table]
            _warned_uncalibrated.discard(key)
            n += 1
    return n


def clear_hierarchical_decisions() -> None:
    """Forget every table; a later uncalibrated query may load
    ``$HVDTPU_AUTOTUNE_LOG`` again, as a new process would."""
    global _env_loaded
    with _lock:
        _decisions.clear()
        _warned_uncalibrated.clear()
        _env_loaded = False


def _variant_fn(kind: str, inner_axis: str, outer_axis: str) -> Callable:
    """The flat or the hierarchical Sum allreduce the calibration times:
    flat is one allreduce over both axes' group, not two in turn."""
    if kind == "flat":
        group = runtime.group((inner_axis, outer_axis))
        return lambda x: C._launch_reduce(x, C.ReduceOp.SUM, 1.0, 1.0,
                                          inplace=True, group=group).wait()
    return lambda x: C._launch_hierarchical(x, C.ReduceOp.SUM, inner_axis,
                                            outer_axis).wait()


def _default_measure(kind: str, nbytes: int, inner_axis: str,
                     outer_axis: str, reps: int) -> float:
    """Median seconds of one call of the flat or hierarchical allreduce of
    ``nbytes`` of fp32 over the live mesh: by CUDA events on the card, by
    ``perf_counter`` on the CPU."""
    dev = runtime.device()
    x = torch.ones(max(nbytes // 4, 1), dtype=torch.float32, device=dev)
    fn = _variant_fn(kind, inner_axis, outer_axis)
    fn(x)  # warm: the communicators are created on first use
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(x)
            times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def autotune_hierarchical(inner_axis: str, outer_axis: str,
                          sizes: Tuple[int, ...] = (1 << 20, 16 << 20,
                                                    128 << 20),
                          reps: int = 5,
                          measure: Optional[Callable] = None) -> dict:
    """Time flat and hierarchical allreduce at each size and record the
    faster; returns ``{nbytes: (choice, flat_s, hier_s)}``. Every rank
    measures, then rank 0's timings are broadcast, so every rank records
    the same choices (reference: ``Controller::SynchronizeParameters``);
    with ``$HVDTPU_AUTOTUNE_LOG`` set, rank 0 saves the table."""
    m = measure if measure is not None else _default_measure
    sizes_sorted = sorted(sizes)
    times = torch.tensor(
        [[m("flat", nb, inner_axis, outer_axis, reps),
          m("hierarchical", nb, inner_axis, outer_axis, reps)]
         for nb in sizes_sorted], dtype=torch.float64,
        device=runtime.device())
    times = C._broadcast(times, root_rank=0).tolist()
    results = {}
    table: List[Tuple[int, str]] = []
    for (flat_s, hier_s), nbytes in zip(times, sizes_sorted):
        choice = "hierarchical" if hier_s < flat_s else "flat"
        results[nbytes] = (choice, flat_s, hier_s)
        table.append((nbytes, choice))
        log.info("autotune_hierarchical[%s,%s] %d bytes: flat=%.3fms "
                 "hier=%.3fms -> %s", inner_axis, outer_axis, nbytes,
                 flat_s * 1e3, hier_s * 1e3, choice)
    with _lock:
        key = _mesh_key(inner_axis, outer_axis)
        _decisions[key] = table
        _warned_uncalibrated.discard(key)
    if runtime.rank() == 0:
        try:
            save_hierarchical_decisions()
        except OSError as exc:
            log.warning("autotune_hierarchical: could not save the table "
                        "to $%s: %s", _AUTOTUNE_LOG_ENV, exc)
    return results


def choose_hierarchical(inner_axis: str, outer_axis: str,
                        nbytes: int) -> bool:
    """True if the table of this mesh says hierarchical wins at ``nbytes``
    (the nearest measured size in log space decides). Without a table, and
    none in ``$HVDTPU_AUTOTUNE_LOG``, flat, with a warning once: the
    reference's hierarchical-off default."""
    global _env_loaded
    key = _mesh_key(inner_axis, outer_axis)
    with _lock:
        table = _decisions.get(key)
    if not table and not _env_loaded and ev.get_str(_AUTOTUNE_LOG_ENV):
        _env_loaded = True
        try:
            load_hierarchical_decisions()
        except Exception as exc:
            # A corrupt log must never stop a job: warn and go flat.
            log.warning("choose_hierarchical: could not load $%s: %s: %s",
                        _AUTOTUNE_LOG_ENV, type(exc).__name__, exc)
        with _lock:
            table = _decisions.get(key)
    if not table:
        if key not in _warned_uncalibrated:
            _warned_uncalibrated.add(key)
            log.warning("hierarchical='auto' over (%s,%s) without "
                        "calibration for mesh %s: reducing flat; run "
                        "hvd.autotune_hierarchical(inner, outer) once after "
                        "init", inner_axis, outer_axis, key[2])
        return False
    ln = math.log(max(nbytes, 1))
    best = min(table, key=lambda entry: abs(math.log(entry[0]) - ln))
    return best[1] == "hierarchical"
