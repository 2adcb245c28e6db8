"""Reading a ``torch.profiler`` Chrome trace of the traced window.

The window is the host annotation ``WINDOW`` that the harness opens around
the traced steps and the ``torch.cuda.synchronize()`` after them. A device
operation is a kernel, a copy or a memset; the device is busy where any
runs (the union of their intervals), and idle elsewhere in the window. An
idle gap is labelled by what the host was doing at its middle: the
innermost event open then on the host thread that ran the steps (an
operator, a runtime call such as ``cudaStreamSynchronize``), or ``host
idle`` where none was.

Interval arithmetic on sorted ``(start, end)`` pairs: :func:`union`,
:func:`length`, :func:`minus`.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Tuple

WINDOW = "hvdbench.window"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def minus(keep: Iterable[Interval], cut: Iterable[Interval]) -> float:
    """The length of ``keep``'s union outside ``cut``'s union."""
    cut = union(cut)
    total, j = 0.0, 0
    for start, end in union(keep):
        while j < len(cut) and cut[j][1] <= start:
            j += 1
        pos, k = start, j
        while k < len(cut) and cut[k][0] < end:
            if cut[k][0] > pos:
                total += cut[k][0] - pos
            pos = max(pos, cut[k][1])
            k += 1
        if pos < end:
            total += end - pos
    return total


def _label_gaps(gaps: List[Interval], host: List[Tuple[str, float, float]]
                ) -> Dict[str, float]:
    """Each gap's length under the innermost host event open at its
    middle (events of one thread nest)."""
    host = sorted(host, key=lambda e: (e[1], -e[2]))
    out: Dict[str, float] = collections.defaultdict(float)
    stack: List[Tuple[str, float, float]] = []
    i = 0
    for start, end in sorted(gaps):
        mid = (start + end) / 2
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out[stack[-1][0] if stack else "host idle"] += end - start
    return out


def digest(path: str) -> dict:
    """The traced window of the trace at ``path``: its length (``window_us``),
    its device operations (``device``: ``[name, category, start, end]``,
    µs from the window's start, clipped to it) and its idle time by what
    the host was doing (``gaps``: ``[label, µs]``, longest first, at most
    ``TOP``). None where the trace holds no window."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW and
               e.get("cat") == "user_annotation"]
    if not windows:
        return None
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = []
    for e in events:
        if e.get("cat") not in DEVICE:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end > w0 and start < w1:
            device.append([e["name"], e["cat"], max(start, w0) - w0,
                           min(end, w1) - w0])
    host = [(e["name"], float(e["ts"]) - w0,
             float(e["ts"]) + float(e["dur"]) - w0) for e in events
            if e.get("cat") in HOST and e.get("tid") == win.get("tid") and
            e is not win]
    busy = union((d[2], d[3]) for d in device)
    edges = [0.0] + [x for iv in busy for x in iv] + [w1 - w0]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    labelled = sorted(_label_gaps(gaps, host).items(), key=lambda kv: -kv[1])
    return {"window_us": w1 - w0, "device": device,
            "gaps": [[name, us] for name, us in labelled[:TOP]]}


def top_ops(device: List[list], top: int = TOP) -> List[Tuple[str, float]]:
    """Device time by operation name (µs), longest first."""
    total: Dict[str, float] = collections.defaultdict(float)
    for name, _, start, end in device:
        total[name] += end - start
    return sorted(total.items(), key=lambda kv: -kv[1])[:top]
