"""Post-mortem forensics over flight-recorder dumps
(docs/fault-tolerance.md "Post-mortem debugging").

On job failure every surviving rank freezes its in-memory flight ring to
``flightrec.<rank>.bin`` (abort cascade / stall escalation / fatal signal —
``native/flightrec.{h,cpp}``). This module turns a directory of those dumps
into answers:

* :func:`build_verdict` — which rank died or hung, its last in-flight op
  and hop peer, and what every surviving rank was blocked on. A rank that
  was SIGKILLed leaves no dump; it is convicted by absence plus the
  survivors' ``fail_detect`` votes, and its last op is inferred from the
  collective the survivors were blocked inside (a collective is the same
  op on every rank).
* :func:`merge_to_chrome` — one clock-aligned Perfetto trace of the last
  ``window_ms`` milliseconds before the freeze, per-rank process groups,
  reusing the trace merge machinery (:func:`trace_analysis.merge_events`)
  with the dump headers' clock offsets as the alignment metadata.

``python -m horovod_tpu_torch.postmortem`` is the CLI; ``hvdrun --postmortem
DIR`` runs it automatically when a job fails. No reference analog.

The port's own copy of ``horovod_tpu/postmortem.py`` (it imports nothing of
the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional, Tuple

from .flightrec import FlightDump, load_dump_dir
from .trace_analysis import merge_events

# Default merged-view window: the last half second before the freeze is
# where the fatal op lives; everything older is steady-state noise.
DEFAULT_WINDOW_MS = 500

_SIGNAMES = {4: "SIGILL", 6: "SIGABRT", 7: "SIGBUS", 8: "SIGFPE",
             11: "SIGSEGV", 15: "SIGTERM"}

# Byte-for-byte mirror of hvdtpu::OpType (native/common.h) — an OP_BEGIN
# record's arg is the raw code. Held in sync by check_invariants.py
# (ENUM-MIRROR); kept as a local literal so the analyzer stays importable
# without the runtime half of the package.
_OP_TYPES = {"allreduce": 0, "allgather": 1, "broadcast": 2, "alltoall": 3,
             "reducescatter": 4, "join": 5}
_OP_CODES = {v: k.upper() for k, v in _OP_TYPES.items()}


def _dump_to_chrome(dump: FlightDump) -> list:
    """One rank's ring as Chrome-trace events + the synthetic ``trace_meta``
    record :func:`trace_analysis.merge_events` aligns on. Timestamps are
    absolute steady-clock us (steady_init_us = 0, so the shift is exactly
    the header's clock offset vs rank 0)."""
    events: List[dict] = [{
        "pid": "__hvdtpu_trace_meta", "name": "trace_meta", "ph": "i",
        "ts": dump.steady_now_us, "s": "p",
        "args": {"clock_offset_us": dump.clock_offset_us,
                 "clock_err_us": dump.clock_err_us,
                 "steady_init_us": 0},
    }]
    open_op: Optional[Tuple[str, int]] = None  # (name, begin ts)
    for ev in dump.events:
        if ev.type == "op_begin":
            open_op = (ev.name, ev.t_end_us)
            continue
        if ev.type == "op_end":
            start = ev.t_start_us
            if open_op is not None and open_op[0] == ev.name:
                start = min(start, open_op[1])
            open_op = None
            events.append({"pid": "ops", "name": ev.name or "<op>",
                           "ph": "X", "ts": start,
                           "dur": max(ev.t_end_us - start, 1),
                           "args": {"bytes": ev.bytes,
                                    "ok": int(ev.arg == 0)}})
            continue
        if ev.type in ("send", "recv", "sendrecv", "reduce", "quantize",
                       "dequantize"):
            events.append({"pid": "hops", "name": ev.type.upper(),
                           "ph": "X", "ts": ev.t_start_us,
                           "dur": max(ev.dur_us, 1),
                           "args": {"send_peer": ev.send_peer,
                                    "recv_peer": ev.recv_peer,
                                    "bytes": ev.bytes, "lane": ev.lane,
                                    "wait_us": ev.arg}})
            continue
        if ev.type == "fusion_wait":
            events.append({"pid": ev.name or "fusion", "name": "FUSION-WAIT",
                           "ph": "X", "ts": ev.t_start_us,
                           "dur": max(ev.dur_us, 1),
                           "args": {"tensors": ev.arg,
                                    "batch_bytes": ev.bytes}})
            continue
        # fail_detect / stall / abort / mark: instants on an "events" row.
        events.append({"pid": "events", "name": ev.type.upper(), "ph": "i",
                       "ts": ev.t_end_us, "s": "p",
                       "args": {"peer": ev.send_peer, "name": ev.name,
                                "arg": ev.arg}})
    # A still-open op at freeze time renders as a span to the ring's end —
    # THE slice to look at in the merged view.
    if open_op is not None and dump.events:
        events.append({"pid": "ops", "name": open_op[0] + " (in flight)",
                       "ph": "X", "ts": open_op[1],
                       "dur": max(dump.events[-1].t_end_us - open_op[1], 1),
                       "args": {"inflight": 1}})
    return events


def merge_to_chrome(dumps: Dict[int, FlightDump],
                    window_ms: int = DEFAULT_WINDOW_MS) -> list:
    """Clock-aligned merged Perfetto view of the last ``window_ms`` before
    the latest event across all dumps (0 = everything the rings kept)."""
    per_rank = {r: _dump_to_chrome(d) for r, d in dumps.items()}
    merged, _metas = merge_events(per_rank)
    if window_ms > 0:
        end = max((e["ts"] + e.get("dur", 0) for e in merged if "ts" in e),
                  default=0)
        cutoff = end - window_ms * 1000
        merged = [e for e in merged
                  if "ts" not in e or e["ts"] + e.get("dur", 0) >= cutoff or
                  e.get("ph") == "M"]
    return merged


def _blocked_on(dump: FlightDump) -> dict:
    """What this rank was doing when its ring froze. A survivor's fatal op
    closes with an error status before the dump (the abort cascade breaks
    it), so the last FAILED op counts as much as a still-open one."""
    inflight = dump.last_inflight_op() or dump.last_failed_op()
    hop = dump.last_hop()
    suspects = [ev.send_peer for ev in dump.events
                if ev.type == "fail_detect" and ev.send_peer >= 0]
    if dump.reason == "abort" and dump.detail >= 0:
        suspects.append(dump.detail)
    return {
        "rank": dump.rank,
        "dump_reason": dump.reason,
        "detail": dump.detail,
        "inflight_op": None if inflight is None else inflight.name,
        "inflight_kind": None if inflight is None
        else _OP_CODES.get(inflight.arg, str(inflight.arg)),
        "inflight_bytes": None if inflight is None else inflight.bytes,
        "last_hop": None if hop is None else {
            "type": hop.type, "send_peer": hop.send_peer,
            "recv_peer": hop.recv_peer, "bytes": hop.bytes,
            "lane": hop.lane},
        "suspects": suspects,
    }


def build_verdict(dumps: Dict[int, FlightDump],
                  local_ranks: Optional[set] = None) -> dict:
    """The who/what/why of a dead job, from whatever dumps survived.

    ``local_ranks``: ranks whose dumps are expected in THIS directory (the
    launcher knows which ranks ran on the driver's host). A rank absent
    from the dump set is convicted as dead only when its dump should have
    landed here; a remote rank's missing dump means "not collected yet",
    not death. None = topology unknown: absence still convicts, and the
    formatted verdict carries the multi-host caveat.
    """
    if not dumps:
        raise FileNotFoundError("no flightrec.<rank>.bin dumps to analyze")
    world = max(d.world_size for d in dumps.values())
    present = set(dumps)
    per_rank = {r: _blocked_on(d) for r, d in sorted(dumps.items())}

    dead: List[dict] = []
    terminated: List[int] = []
    # Ranks that dumped because a fatal signal hit THEM died with evidence —
    # except SIGTERM, which is how launchers/watchdogs clean up survivors
    # after the ORIGINAL failure (convicting those would blame the victims).
    for r, info in per_rank.items():
        if info["dump_reason"] == "signal":
            if info["detail"] == 15:
                terminated.append(r)
            else:
                dead.append({"rank": r, "how": _SIGNAMES.get(
                    info["detail"], f"signal {info['detail']}"),
                    "evidence": "own fatal-signal dump"})
    # HVDTPU_NANCHECK=abort fail-fasts dump with reason "nonfinite": the
    # rank broke the world BY POLICY, and its own ring carries the
    # NONFINITE record naming the offending tensor (docs/numerics.md).
    nonfinite: List[dict] = []
    for r, d in sorted(dumps.items()):
        if d.reason != "nonfinite":
            continue
        tensor = None
        for ev in reversed(d.events):
            if ev.type == "nonfinite":
                tensor = ev.name
                break
        nonfinite.append({"rank": r, "tensor": tensor})
        if not any(x["rank"] == r for x in dead):
            where = f" in tensor '{tensor}'" if tensor else ""
            dead.append({"rank": r,
                         "how": f"aborted on a non-finite gradient{where} "
                                "(HVDTPU_NANCHECK=abort)",
                         "evidence": "own NONFINITE dump"})
    # Ranks with no dump at all: SIGKILLed / lost before any handler ran —
    # unless they ran on a REMOTE host, where a missing dump just means it
    # was never copied here (uncollected, not dead).
    uncollected: List[int] = []
    for r in sorted(set(range(world)) - present):
        if local_ranks is not None and r not in local_ranks:
            uncollected.append(r)
            continue
        dead.append({"rank": r, "how": "no dump (SIGKILL or host lost)",
                     "evidence": "absent from the dump set"})

    votes = Counter()
    for info in per_rank.values():
        votes.update(set(info["suspects"]))  # one vote per surviving rank
    suspect = None
    if votes:
        suspect, nvotes = votes.most_common(1)[0]
        if not any(d["rank"] == suspect for d in dead):
            dead.append({
                "rank": suspect,
                "how": "hung or unresponsive (lane failures pinned on it)",
                "evidence": f"named by {nvotes}/{len(per_rank)} surviving "
                            "rank(s)"})

    stalled = [r for r, d in dumps.items() if d.reason == "stall"]
    # A stall escalation freezes the coordinator's ring with the tensor and
    # the first rank that never announced it — the wedged-world suspect
    # when no lane ever failed (nothing was on the wire to detect).
    for r in stalled:
        for ev in dumps[r].events:
            if ev.type == "stall" and ev.arg == 1 and ev.send_peer >= 0:
                if suspect is None:
                    suspect = ev.send_peer
                if not any(d["rank"] == ev.send_peer for d in dead):
                    dead.append({
                        "rank": ev.send_peer,
                        "how": f"hung: never announced tensor "
                               f"'{ev.name}' (stall escalation)",
                        "evidence": f"coordinator rank {r}'s stall record"})

    # The dead rank's last op: its own dump if it managed one, else the
    # collective the survivors were blocked inside (identical op order on
    # every rank — the negotiated response list is broadcast).
    fatal_op = None
    dead_ranks = [d["rank"] for d in dead]
    for r in dead_ranks:
        if r in per_rank and per_rank[r]["inflight_op"]:
            fatal_op = {"rank": r, "name": per_rank[r]["inflight_op"],
                        "kind": per_rank[r]["inflight_kind"],
                        "source": "the dead rank's own dump"}
            break
    if fatal_op is None:
        blocked = Counter(
            (info["inflight_op"], info["inflight_kind"])
            for info in per_rank.values()
            if info["inflight_op"] and info["rank"] not in dead_ranks)
        if blocked:
            (name, kind), n = blocked.most_common(1)[0]
            fatal_op = {"rank": dead_ranks[0] if dead_ranks else None,
                        "name": name, "kind": kind,
                        "source": f"inferred from {n} blocked survivor(s)"}

    clock = {r: {"offset_us": d.clock_offset_us, "err_us": d.clock_err_us}
             for r, d in sorted(dumps.items())}
    return {
        "world_size": world,
        "ranks_dumped": sorted(present),
        "dead": sorted(dead, key=lambda d: d["rank"]),
        "nonfinite": nonfinite,
        "terminated": sorted(terminated),
        "uncollected": uncollected,
        "topology_known": local_ranks is not None,
        "suspect": suspect,
        "stalled_coordinator": sorted(stalled),
        "fatal_op": fatal_op,
        "per_rank": per_rank,
        "clock": clock,
    }


def format_verdict(verdict: dict) -> str:
    out: List[str] = []
    out.append(f"post-mortem verdict (world size {verdict['world_size']}, "
               f"dumps from ranks {verdict['ranks_dumped']}):")
    if verdict["dead"]:
        for d in verdict["dead"]:
            out.append(f"  DEAD rank {d['rank']}: {d['how']} "
                       f"[{d['evidence']}]")
    else:
        out.append("  no dead rank identified (clean shutdown or "
                   "on-demand dumps)")
    for nf in verdict.get("nonfinite", []):
        tensor = nf.get("tensor")
        out.append(
            f"  non-finite gradient: rank {nf['rank']} tripped "
            f"HVDTPU_NANCHECK=abort"
            + (f" on tensor '{tensor}'" if tensor else "")
            + " — numerical divergence, not a systems failure")
    if verdict["stalled_coordinator"]:
        out.append(f"  stall escalation: coordinator rank(s) "
                   f"{verdict['stalled_coordinator']} broke the world after "
                   "a tensor sat past the shutdown window")
    if verdict["terminated"]:
        out.append(f"  terminated rank(s) {verdict['terminated']}: SIGTERM "
                   "after the failure (launcher/watchdog cleanup, not the "
                   "cause)")
    if verdict.get("uncollected"):
        out.append(f"  uncollected rank(s) {verdict['uncollected']}: ran on "
                   "remote hosts — copy their flightrec.<rank>.bin here and "
                   "re-run python -m horovod_tpu_torch.postmortem for the "
                   "full picture")
    elif not verdict.get("topology_known") and any(
            d["evidence"] == "absent from the dump set"
            for d in verdict["dead"]):
        out.append("  caveat: host topology unknown — an 'absent' rank on "
                   "a REMOTE host may be healthy with its dump still on "
                   "that host")
    op = verdict["fatal_op"]
    if op is not None:
        where = f"rank {op['rank']}" if op["rank"] is not None else "world"
        out.append(f"  fatal op: {op['kind']} '{op['name']}' on {where} "
                   f"({op['source']})")
    for r, info in sorted(verdict["per_rank"].items()):
        line = f"  rank {r} [{info['dump_reason']}]: "
        if info["inflight_op"]:
            line += (f"in {info['inflight_kind']} '{info['inflight_op']}'"
                     f" ({info['inflight_bytes']} B)")
        else:
            line += "idle (no op in flight)"
        hop = info["last_hop"]
        if hop is not None:
            peer = hop["recv_peer"] if hop["recv_peer"] >= 0 \
                else hop["send_peer"]
            line += (f", last hop {hop['type']} peer {peer} over "
                     f"{hop['lane']}")
        if info["suspects"]:
            line += f", pinned failure on rank(s) {sorted(set(info['suspects']))}"
        out.append(line)
    unsynced = [r for r, c in verdict["clock"].items() if c["err_us"] < 0]
    if unsynced:
        out.append(f"  note: rank(s) {unsynced} never clock-synced — their "
                   "timestamps merge unaligned")
    return "\n".join(out)


def run_postmortem(dump_dir: str, out_path: Optional[str] = None,
                   window_ms: int = DEFAULT_WINDOW_MS,
                   local_ranks: Optional[set] = None) -> Tuple[dict, str]:
    """Load dumps, write the merged Perfetto view, return
    ``(verdict, merged_trace_path)``. Raises FileNotFoundError when the
    directory holds no dumps. ``local_ranks``: see :func:`build_verdict`."""
    import json

    dumps = load_dump_dir(dump_dir)
    if not dumps:
        raise FileNotFoundError(
            f"no flightrec.<rank>.bin dumps under {dump_dir!r}")
    merged = merge_to_chrome(dumps, window_ms=window_ms)
    if out_path is None:
        out_path = os.path.join(dump_dir, "merged_postmortem.json")
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return build_verdict(dumps, local_ranks=local_ranks), out_path


def main(argv=None) -> int:
    """The CLI (counterpart of the JAX package's ``scripts/postmortem.py``)::

        python -m horovod_tpu_torch.postmortem DUMP_DIR [-o merged.json]
            [--window-ms 500] [--json]

    DUMP_DIR holds the ``flightrec.<rank>.bin`` files the surviving ranks
    wrote when the job died (``hvdrun-torch --postmortem DIR`` collects
    them and runs this). Writes a merged, clock-aligned Perfetto trace of
    the last ``--window-ms`` and prints the verdict. Exit status: 0 on a
    verdict, 1 when the directory holds no dumps, 2 on bad arguments."""
    import argparse
    import json
    import sys
    p = argparse.ArgumentParser(
        description="Post-mortem forensics over flight-recorder dumps")
    p.add_argument("dump_dir", help="directory of flightrec.<rank>.bin dumps")
    p.add_argument("-o", "--output", default=None,
                   help="merged Perfetto trace path "
                        "(default DUMP_DIR/merged_postmortem.json)")
    p.add_argument("--window-ms", type=int, default=DEFAULT_WINDOW_MS,
                   help="merged-view window before the freeze in ms "
                        "(0 = everything the rings kept; default "
                        f"{DEFAULT_WINDOW_MS})")
    p.add_argument("--json", action="store_true",
                   help="print the verdict as JSON instead of text")
    args = p.parse_args(argv)
    if args.window_ms < 0:
        p.error("--window-ms must be >= 0")
    try:
        verdict, merged_path = run_postmortem(args.dump_dir, args.output,
                                              window_ms=args.window_ms)
    except FileNotFoundError as exc:
        print(f"postmortem: {exc}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(verdict, indent=1))
    else:
        print(format_verdict(verdict))
    print(f"postmortem: merged trace -> {merged_path} "
          "(load in https://ui.perfetto.dev)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
