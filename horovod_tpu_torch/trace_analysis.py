"""Cross-rank trace merging + critical-path/straggler analysis.

The native tracing layer (docs/tracing.md) writes one Chrome-trace JSON per
rank: op-level phases (``NEGOTIATE`` / ``QUEUE`` / the op activity) on
tensor rows, sampled per-hop child spans (``SEND`` / ``RECV`` /
``SENDRECV`` / ``REDUCE`` / ``QUANTIZE`` / ``DEQUANTIZE``) on the ``hops``
row, ``FUSION-WAIT`` tensor spans, and a ``trace_meta`` event carrying the
rank's steady-clock offset ± error vs rank 0 (estimated by ping-pong
exchanges on the form-up handshake and refreshed through the control
plane).

This module is the analysis half:

* :func:`load_trace_dir` / :func:`merge_events` — shift every rank's
  events onto rank 0's clock (offset from the metadata) and merge them
  into one Perfetto-loadable trace, one process group per rank;
* :func:`build_report` — per-op critical path (which rank's which phase
  gated completion), straggler ranking with wait-time attribution
  (compute-late vs wire-slow vs peer-wait), fusion-efficiency and
  lane/compression breakdowns;
* :func:`diff_reports` — compare two runs phase by phase.

``python -m horovod_tpu_torch.trace_analysis`` is the CLI; ``hvdrun --trace
DIR`` merges automatically at job end. No reference analog: the reference
timeline stops at per-rank files and leaves cross-rank questions to the
reader.

The port's own copy of ``horovod_tpu/trace_analysis.py`` (it imports nothing
of the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

# Op activities emitted by the native core (core.cpp ExecuteResponse).
OP_ACTIVITIES = ("ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL",
                 "REDUCESCATTER")
# Hop-span names (data_plane.cpp TraceHop) carrying a wait_us split.
WIRE_HOPS = ("SEND", "RECV", "SENDRECV")
COMPUTE_HOPS = ("REDUCE",)
CODEC_HOPS = ("QUANTIZE", "DEQUANTIZE")
HOPS_TRACK = "hops"
META_TRACK = "__hvdtpu_trace_meta"

_TRACE_FILE_RE = re.compile(r"\.(\d+)\.json$")


def load_trace_dir(path: str) -> Dict[int, list]:
    """Per-rank event lists from a trace directory: every ``*.<rank>.json``
    (``trace.0.json``, ``tl.3.json``, ...) keyed by its rank suffix."""
    per_rank: Dict[int, list] = {}
    for name in sorted(os.listdir(path)):
        m = _TRACE_FILE_RE.search(name)
        if m is None:
            continue
        rank = int(m.group(1))
        with open(os.path.join(path, name)) as f:
            events = json.load(f)
        if isinstance(events, list):
            # Two files claiming one rank (trace.0.json + tl.0.json) would
            # silently interleave two runs; keep the first alphabetically
            # and let the caller notice via rank count.
            per_rank.setdefault(rank, events)
    return per_rank


def rank_meta(events: list) -> Optional[dict]:
    """The rank's trace metadata: the LAST ``trace_meta`` event with a
    known clock error, else the last one at all (err < 0 = never synced)."""
    best = None
    for e in events:
        if e.get("pid") == META_TRACK and e.get("name") == "trace_meta":
            args = e.get("args", {})
            if best is None or args.get("clock_err_us", -1) >= 0:
                best = args
    return best


def _rank_shift_us(meta: Optional[dict]) -> Tuple[int, int]:
    """(shift, err): add ``shift`` to a rank's ts to land on rank 0's
    steady axis. Without metadata the shift is 0 and err is flagged -1 —
    the merge still renders, just unaligned (and the report says so)."""
    if not meta:
        return 0, -1
    return (int(meta.get("steady_init_us", 0)) +
            int(meta.get("clock_offset_us", 0)),
            int(meta.get("clock_err_us", -1)))


def merge_events(per_rank: Dict[int, list]) -> Tuple[list, Dict[int, dict]]:
    """One globally-aligned event list from per-rank traces.

    Every event's ts moves onto rank 0's steady clock (minus a common
    origin so the merged trace starts near 0); pid becomes ``rank <r>`` —
    one Perfetto process group per rank — and the original pid (tensor
    name / ``hops``) becomes the tid row. Returns (events, meta_by_rank).
    """
    metas = {r: rank_meta(ev) or {} for r, ev in per_rank.items()}
    shifts = {r: _rank_shift_us(metas.get(r))[0] for r in per_rank}
    origin = None
    for r, events in per_rank.items():
        for e in events:
            if "ts" in e:
                t = int(e["ts"]) + shifts[r]
                origin = t if origin is None else min(origin, t)
    origin = origin or 0

    merged: list = []
    for r in sorted(per_rank):
        merged.append({"name": "process_name", "ph": "M", "pid": f"rank {r}",
                       "args": {"name": f"rank {r}"}})
        for e in per_rank[r]:
            out = dict(e)
            if "ts" in out:
                out["ts"] = int(out["ts"]) + shifts[r] - origin
            out["tid"] = str(e.get("pid", ""))
            out["pid"] = f"rank {r}"
            args = dict(out.get("args") or {})
            args["rank"] = r
            out["args"] = args
            merged.append(out)
    return merged, metas


class OpOccurrence:
    """One collective op on one rank: the activity interval (global us)
    plus the hop spans it contains (sampled ops only)."""

    def __init__(self, rank: int, name: str, op: str, index: int,
                 start_us: int, end_us: int, args: dict):
        self.rank = rank
        self.name = name          # primary tensor name (trace row)
        self.op = op              # ALLREDUCE / ...
        self.index = index        # k-th occurrence of this tensor's op
        self.start_us = start_us  # global (rank-0 axis) microseconds
        self.end_us = end_us
        self.args = args          # transport/compression tags from the B
        self.hops: List[dict] = []

    @property
    def duration_us(self) -> int:
        return self.end_us - self.start_us

    def phase_breakdown(self) -> dict:
        """{wait, wire, reduce, quantize, startup}_us for this rank's leg.

        wire = hop wall time minus its peer-wait share; startup = gap from
        the activity start to the first hop (a rank arriving late at the
        wire — compute/scheduling skew — shows up exactly here)."""
        wait = wire = reduce = quantize = 0
        overlapped_reduce = 0
        first_hop = None
        for h in self.hops:
            dur = int(h.get("dur", 0))
            args = h.get("args", {})
            if first_hop is None or int(h["ts"]) < first_hop:
                first_hop = int(h["ts"])
            if h["name"] in WIRE_HOPS:
                w = int(args.get("wait_us", 0))
                wait += min(w, dur)
                wire += max(dur - w, 0)
            elif h["name"] in COMPUTE_HOPS:
                busy = args.get("busy_us")
                if busy is not None:
                    # Segmented-ring reduction runs INSIDE the exchange
                    # whose SENDRECV span already covers it: count it as
                    # reduce and take it back out of the wire share below,
                    # or ring ops could never classify as reduce-bound.
                    reduce += int(busy)
                    overlapped_reduce += int(busy)
                else:
                    reduce += dur  # RD/tree reduce: outside any hop span
            elif h["name"] in CODEC_HOPS:
                quantize += dur
        wire = max(wire - overlapped_reduce, 0)
        startup = (max(first_hop - self.start_us, 0)
                   if first_hop is not None else 0)
        return {"wait_us": wait, "wire_us": wire, "reduce_us": reduce,
                "quantize_us": quantize, "startup_us": startup}


def _extract_ops(events: list, rank: int, shift_us: int,
                 origin_us: int) -> List[OpOccurrence]:
    """Walk one rank's events in file order and pair each op activity's B
    with its matching E (per tensor row, innermost-first), then attach the
    hop spans the interval contains. Fused tensors share one wall
    interval; they are deduped to one occurrence (first name wins, the
    rest recorded in args["fused_names"])."""
    ops: List[OpOccurrence] = []
    open_b: Dict[str, list] = {}  # pid -> stack of (name, ts, args)
    counts: Dict[str, int] = {}
    for e in events:
        pid = e.get("pid", "")
        ph = e.get("ph")
        if pid in (HOPS_TRACK, META_TRACK, "cycle"):
            continue
        if ph == "B":
            open_b.setdefault(pid, []).append(e)
        elif ph == "E":
            stack = open_b.get(pid)
            if not stack:
                continue
            b = stack.pop()
            if b.get("name") not in OP_ACTIVITIES:
                continue
            key = f"{pid}\x00{b['name']}"
            k = counts.get(key, 0)
            counts[key] = k + 1
            ops.append(OpOccurrence(
                rank, pid, b["name"], k,
                int(b["ts"]) + shift_us - origin_us,
                int(e["ts"]) + shift_us - origin_us,
                dict(b.get("args") or {})))

    # Dedupe fused entries: a rank executes collectives serially, so two
    # op intervals can only OVERLAP when they are one data-plane op
    # announced under several fused tensor rows (whose per-entry B/E
    # events carry timestamps a few µs apart — exact-equality matching
    # would never fire). Fused entries emit consecutively, so comparing
    # against the last kept occurrence suffices.
    deduped: List[OpOccurrence] = []
    for op in ops:
        prev = deduped[-1] if deduped else None
        if (prev is not None and op.op == prev.op and
                op.start_us < prev.end_us and op.end_us > prev.start_us):
            prev.args.setdefault("fused_names", []).append(op.name)
            prev.start_us = min(prev.start_us, op.start_us)
            prev.end_us = max(prev.end_us, op.end_us)
            continue
        deduped.append(op)

    hops = sorted((e for e in events
                   if e.get("pid") == HOPS_TRACK and e.get("ph") == "X"),
                  key=lambda e: int(e["ts"]))
    for h in hops:
        h = dict(h)
        h["ts"] = int(h["ts"]) + shift_us - origin_us
        for op in deduped:
            if op.start_us <= h["ts"] <= op.end_us:
                op.hops.append(h)
                break
    return deduped


def correlate_ops(per_rank: Dict[int, list]) -> List[Dict[int, OpOccurrence]]:
    """Cross-rank op table: occurrence k of tensor T on every rank is the
    same negotiated collective (the response list is broadcast, so op
    order is identical everywhere). Returns one {rank: OpOccurrence} per
    collective, sorted by earliest start."""
    metas = {r: rank_meta(ev) or {} for r, ev in per_rank.items()}
    shifts = {r: _rank_shift_us(metas.get(r))[0] for r in per_rank}
    origin = min((shifts[r] for r in per_rank), default=0)

    by_key: Dict[tuple, Dict[int, OpOccurrence]] = {}
    for r, events in per_rank.items():
        for op in _extract_ops(events, r, shifts[r], origin):
            by_key.setdefault((op.name, op.op, op.index), {})[r] = op
    return sorted(by_key.values(),
                  key=lambda m: min(o.start_us for o in m.values()))


def _classify(phases: dict) -> str:
    """Attribute a rank's non-wait time: where did its op leg actually
    go? startup (late at the wire) => compute-late; wire => wire-slow;
    reduce/quantize => compute-bound; wait => peer-wait (a victim, not a
    straggler)."""
    buckets = {"compute-late": phases["startup_us"],
               "wire-slow": phases["wire_us"],
               "reduce-bound": phases["reduce_us"],
               "quantize-bound": phases["quantize_us"],
               "peer-wait": phases["wait_us"]}
    return max(buckets, key=lambda k: buckets[k])


def build_report(trace_dir: str,
                 per_rank: Optional[Dict[int, list]] = None) -> dict:
    """The full analysis: per-op critical path, straggler ranking,
    lane/compression and fusion breakdowns. All times in microseconds.
    Pass ``per_rank`` (from :func:`load_trace_dir`) to reuse already-loaded
    traces — callers that also merge would otherwise parse multi-MB files
    twice."""
    if per_rank is None:
        per_rank = load_trace_dir(trace_dir)
    if not per_rank:
        raise FileNotFoundError(
            f"no *.<rank>.json traces under {trace_dir!r}")
    metas = {r: rank_meta(ev) or {} for r, ev in per_rank.items()}
    table = correlate_ops(per_rank)

    critical = []
    per_rank_stats: Dict[int, dict] = {
        r: {"ops": 0, "active_us": 0, "wait_us": 0, "wire_us": 0,
            "startup_us": 0, "reduce_us": 0, "quantize_us": 0}
        for r in per_rank}
    lanes: Dict[tuple, dict] = {}
    for occ in table:
        sampled = {r: o for r, o in occ.items() if o.hops}
        if not sampled:
            continue
        start = min(o.start_us for o in occ.values())
        end = max(o.end_us for o in occ.values())
        # The gating rank is the one whose OWN (non-wait) time dominated
        # the op — every rank ends at roughly the same instant (the
        # collective is a barrier), so "who finished last" is jitter, while
        # "who did the others wait for" is the actual critical path.
        breakdowns = {r: o.phase_breakdown() for r, o in sampled.items()}
        gate_rank = max(
            breakdowns,
            key=lambda r: sampled[r].duration_us - breakdowns[r]["wait_us"])
        gate_phases = breakdowns[gate_rank]
        # Attribute the gating rank's own time; its (small) waits never win.
        gate_phase = _classify(dict(gate_phases, wait_us=0))
        any_op = next(iter(occ.values()))
        row = {
            "name": any_op.name,
            "op": any_op.op,
            "index": any_op.index,
            "duration_us": end - start,
            "gating_rank": gate_rank,
            "gating_phase": gate_phase,
            "phases": gate_phases,
            "transport": any_op.args.get("transport", ""),
            "compression": any_op.args.get("compression", ""),
        }
        critical.append(row)

        for r, o in sampled.items():
            ph = breakdowns[r]
            st = per_rank_stats[r]
            st["ops"] += 1
            st["wait_us"] += ph["wait_us"]
            st["wire_us"] += ph["wire_us"]
            st["startup_us"] += ph["startup_us"]
            st["reduce_us"] += ph["reduce_us"]
            st["quantize_us"] += ph["quantize_us"]
            st["active_us"] += max(o.duration_us - ph["wait_us"], 0)

        lane_key = (any_op.args.get("transport", ""),
                    any_op.args.get("compression", ""))
        lane = lanes.setdefault(lane_key, {"ops": 0, "duration_us": 0})
        lane["ops"] += 1
        lane["duration_us"] += end - start

    stragglers = []
    for r, st in sorted(per_rank_stats.items()):
        if st["ops"] == 0:
            continue
        phases = {k: st[k] for k in ("wait_us", "wire_us", "startup_us",
                                     "reduce_us", "quantize_us")}
        stragglers.append({
            "rank": r,
            "ops": st["ops"],
            "mean_active_us": st["active_us"] / st["ops"],
            "mean_wait_us": st["wait_us"] / st["ops"],
            "attribution": _classify({
                "startup_us": st["startup_us"], "wire_us": st["wire_us"],
                "reduce_us": st["reduce_us"],
                "quantize_us": st["quantize_us"],
                # Attribution names where the rank's own time goes; its
                # wait makes it a victim, so waits never win here.
                "wait_us": 0}),
            "phases": phases,
        })
    stragglers.sort(key=lambda s: -s["mean_active_us"])

    fusion = {"spans": 0, "mean_wait_us": 0.0, "mean_tensors": 0.0}
    waits, tensors = [], []
    for r, events in per_rank.items():
        for e in events:
            if e.get("name") == "FUSION-WAIT" and e.get("ph") == "X":
                waits.append(int(e.get("dur", 0)))
                tensors.append(int((e.get("args") or {}).get("tensors", 1)))
    if waits:
        fusion = {"spans": len(waits),
                  "mean_wait_us": sum(waits) / len(waits),
                  "mean_tensors": sum(tensors) / len(tensors)}

    clock = {r: {"offset_us": int(m.get("clock_offset_us", 0)),
                 "err_us": int(m.get("clock_err_us", -1))}
             for r, m in metas.items()}
    return {
        "trace_dir": os.path.abspath(trace_dir),
        "ranks": sorted(per_rank),
        "clock": clock,
        "critical_path": critical,
        "stragglers": stragglers,
        "lanes": [{"transport": t, "compression": c, **v}
                  for (t, c), v in sorted(lanes.items())],
        "fusion": fusion,
        "ops_total": len(table),
        "ops_sampled": len(critical),
    }


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{int(us)}us"


def format_report(report: dict) -> str:
    """Human-readable report text (the hvdrun end-of-job summary and the
    CLI default output)."""
    out: List[str] = []
    out.append(f"trace: {report['trace_dir']}")
    out.append(f"ranks: {report['ranks']}  ops: {report['ops_total']} "
               f"({report['ops_sampled']} sampled with hop spans)")
    out.append("clock alignment vs rank 0 (offset ± error):")
    for r, c in sorted(report["clock"].items()):
        err = c["err_us"]
        out.append(f"  rank {r}: {c['offset_us']}us ± "
                   f"{err if err >= 0 else 'unsynced'}us")

    out.append("")
    out.append("critical path (gating rank + phase per sampled op):")
    out.append("  op                         dur       gate  phase         "
               "wait      wire      startup")
    for row in report["critical_path"]:
        ph = row["phases"]
        out.append(
            f"  {row['name'][:24]:<24}   {_fmt_us(row['duration_us']):<8}  "
            f"r{row['gating_rank']:<4} {row['gating_phase']:<13} "
            f"{_fmt_us(ph.get('wait_us', 0)):<9} "
            f"{_fmt_us(ph.get('wire_us', 0)):<9} "
            f"{_fmt_us(ph.get('startup_us', 0))}")

    out.append("")
    out.append("straggler ranking (mean non-wait time per sampled op; the "
               "top rank is the one the others waited for):")
    for s in report["stragglers"]:
        out.append(
            f"  rank {s['rank']}: active {_fmt_us(s['mean_active_us'])}/op, "
            f"waiting {_fmt_us(s['mean_wait_us'])}/op over {s['ops']} ops "
            f"-> {s['attribution']}")

    if report["lanes"]:
        out.append("")
        out.append("lane/compression breakdown:")
        for lane in report["lanes"]:
            mean = lane["duration_us"] / max(lane["ops"], 1)
            out.append(f"  transport={lane['transport'] or '?'} "
                       f"compression={lane['compression'] or '?'}: "
                       f"{lane['ops']} ops, mean {_fmt_us(mean)}")

    f = report["fusion"]
    if f["spans"]:
        out.append("")
        out.append(f"fusion: {f['spans']} tensor spans, mean wait "
                   f"{_fmt_us(f['mean_wait_us'])}, mean "
                   f"{f['mean_tensors']:.1f} tensors/batch")
    return "\n".join(out)


def diff_reports(a: dict, b: dict) -> str:
    """Compare two runs: total critical-path time, per-phase totals on the
    gating legs, and straggler-table movement (--diff mode)."""
    def totals(rep):
        t = {"duration_us": 0, "wait_us": 0, "wire_us": 0, "startup_us": 0,
             "reduce_us": 0, "quantize_us": 0}
        for row in rep["critical_path"]:
            t["duration_us"] += row["duration_us"]
            for k, v in row["phases"].items():
                t[k] = t.get(k, 0) + v
        return t

    ta, tb = totals(a), totals(b)
    out = [f"A: {a['trace_dir']}", f"B: {b['trace_dir']}", ""]
    out.append("gating-leg phase totals (A -> B):")
    for k in ("duration_us", "wait_us", "wire_us", "startup_us",
              "reduce_us", "quantize_us"):
        va, vb = ta.get(k, 0), tb.get(k, 0)
        ratio = f"{vb / va:.2f}x" if va > 0 else "n/a"
        out.append(f"  {k[:-3]:<10} {_fmt_us(va):<10} -> {_fmt_us(vb):<10} "
                   f"({ratio})")
    top_a = a["stragglers"][0]["rank"] if a["stragglers"] else None
    top_b = b["stragglers"][0]["rank"] if b["stragglers"] else None
    out.append(f"straggler: rank {top_a} -> rank {top_b}")
    return "\n".join(out)


def main(argv=None) -> int:
    """The CLI (counterpart of the JAX package's
    ``scripts/trace_analyze.py``)::

        python -m horovod_tpu_torch.trace_analysis DIR [-o merged.json]
            [--json report.json] [--diff DIR_B] [--require-critical-path]

    Merges DIR's ``trace.<rank>.json`` files into one Perfetto-loadable
    trace and prints the critical-path/straggler report. Exit status: 0 on
    success; 2 with ``--require-critical-path`` when no sampled op produced
    a critical-path row."""
    import argparse
    import sys
    p = argparse.ArgumentParser(
        description="Merge per-rank distributed traces + emit the "
                    "critical-path report")
    p.add_argument("trace_dir", help="directory of per-rank *.<rank>.json "
                                     "traces (hvdrun --trace DIR)")
    p.add_argument("-o", "--merged", default=None,
                   help="write the merged clock-aligned Chrome/Perfetto "
                        "trace here (default: <dir>/merged_trace.json)")
    p.add_argument("--no-merged", action="store_true",
                   help="analysis only; skip writing the merged trace")
    p.add_argument("--report", default=None,
                   help="write the text report here (default: stdout)")
    p.add_argument("--json", default=None,
                   help="write the machine-readable report here")
    p.add_argument("--diff", default=None, metavar="TRACE_DIR_B",
                   help="compare against a second run's trace directory")
    p.add_argument("--require-critical-path", action="store_true",
                   help="exit 2 unless the critical-path table is "
                        "non-empty (CI smoke gate)")
    args = p.parse_args(argv)

    per_rank = load_trace_dir(args.trace_dir)
    report = build_report(args.trace_dir, per_rank=per_rank)
    if not args.no_merged:
        merged_path = args.merged or os.path.join(args.trace_dir,
                                                  "merged_trace.json")
        merged, _ = merge_events(per_rank)
        with open(merged_path, "w") as f:
            json.dump(merged, f)
        print(f"merged trace: {merged_path} ({len(merged)} events; load in "
              "https://ui.perfetto.dev)", file=sys.stderr)

    text = format_report(report)
    if args.diff:
        text += "\n\n" + diff_reports(report, build_report(args.diff))
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)

    if args.require_critical_path and not report["critical_path"]:
        print("trace_analyze: no sampled ops -> empty critical-path table "
              "(is HVDTPU_TRACE_SAMPLE 0?)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
