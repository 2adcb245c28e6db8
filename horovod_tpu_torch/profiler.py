"""Sampling-profiler decode/merge layer (docs/profiling.md).

The native side (``native/profiler.{h,cpp}``) samples each registered
thread at ``HVDTPU_PROF_HZ`` via per-thread SIGPROF timers, tags every
sample with the thread's current collective phase + op, and folds the ring
into two equivalent forms at dump time:

* folded-stacks JSON (``hvdtpu_profiler_snapshot`` -> ``hvd.prof_snapshot()``
  / the ``/profz`` endpoint), parsed by :func:`parse_snapshot`;
* flamegraph.pl-compatible folded lines (``prof.<rank>.folded``, written at
  shutdown under ``hvdrun --profile``), parsed by :func:`parse_folded`.

This module converts between the two, merges per-rank files onto one rank-
prefixed stack namespace, renders the per-phase attribution table, and emits
speedscope documents — ``python -m horovod_tpu_torch.profiler`` is the CLI
over it.

Phase names mirror :data:`horovod_tpu_torch.perfstats.PERF_PHASES` (lowercase),
plus ``idle`` for samples taken outside any collective op.

The port's own copy of ``horovod_tpu/profiler.py`` (it imports nothing of
the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from .perfstats import PERF_PHASES

# Phase vocabulary in display order: the PerfPhase buckets plus the
# outside-any-op bucket the profiler adds.
PROF_PHASES: Tuple[str, ...] = tuple(
    sorted(PERF_PHASES, key=PERF_PHASES.get)) + ("idle",)


def parse_snapshot(snap) -> dict:
    """Decode a native folded-stacks JSON snapshot (bytes or str) into its
    document: ``{"enabled", "rank", "hz", "clock", "samples", "phases":
    {phase: count}, "stacks": [{"phase", "op", "count", "frames"}]}``."""
    if isinstance(snap, (bytes, bytearray)):
        snap = snap.decode()
    doc = json.loads(snap)
    if not isinstance(doc, dict) or "stacks" not in doc:
        raise ValueError("not a profiler snapshot (no 'stacks' key)")
    return doc


def to_folded_text(doc: dict) -> str:
    """Render a parsed snapshot back into flamegraph.pl folded lines
    (``phase;op;root;...;leaf count``) — byte-compatible with the
    ``prof.<rank>.folded`` files the native side writes at shutdown."""
    out: List[str] = []
    for stack in doc.get("stacks", []):
        frames = [_sanitize(f) for f in stack.get("frames", [])]
        parts = [stack.get("phase", "idle"),
                 _sanitize(stack.get("op") or "-")]
        # JSON frames are leaf-first; folded lines are root-first.
        parts.extend(reversed(frames))
        out.append(";".join(parts) + f" {int(stack['count'])}")
    return "\n".join(out) + ("\n" if out else "")


def _sanitize(frame: str) -> str:
    return "".join("_" if c in "; \n" else c for c in frame) or "-"


def parse_folded(text: str) -> List[Tuple[List[str], int]]:
    """Parse folded lines into ``[(frames_root_first, count)]``; the phase
    and op ride as the first two frames, exactly as written. Malformed
    lines raise (a truncated profile must fail loudly, not undercount)."""
    out: List[Tuple[List[str], int]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack or not count.lstrip("-").isdigit():
            raise ValueError(f"malformed folded line: {line!r}")
        n = int(count)
        if n <= 0:
            raise ValueError(f"non-positive sample count: {line!r}")
        out.append((stack.split(";"), n))
    return out


def load_folded_dir(prof_dir: str) -> Dict[int, List[Tuple[List[str], int]]]:
    """Read every ``prof.<rank>.folded`` under ``prof_dir`` ->
    ``{rank: parsed stacks}``. Missing dir or no files -> empty dict
    (remote workers keep their profiles on their own hosts)."""
    import glob
    import os
    import re
    out: Dict[int, List[Tuple[List[str], int]]] = {}
    for path in sorted(glob.glob(os.path.join(prof_dir, "prof.*.folded"))):
        m = re.fullmatch(r"prof\.(\d+)\.folded", os.path.basename(path))
        if not m:
            continue
        with open(path) as f:
            out[int(m.group(1))] = parse_folded(f.read())
    return out


def merge_ranks(
        per_rank: Dict[int, List[Tuple[List[str], int]]]) -> List[str]:
    """Merge per-rank stacks into one folded namespace, each stack
    prefixed ``rank<r>`` — one flamegraph whose first split is the rank,
    second the phase, third the op."""
    lines: List[str] = []
    for rank in sorted(per_rank):
        for frames, count in per_rank[rank]:
            lines.append(";".join([f"rank{rank}"] + frames) + f" {count}")
    return lines


def phase_table(
        per_rank: Dict[int, List[Tuple[List[str], int]]]
) -> Dict[int, Dict[str, int]]:
    """Per-rank, per-phase sample attribution: ``{rank: {phase: count}}``.
    The phase is the first folded component; anything outside the known
    vocabulary folds under ``idle`` (defensive: a foreign file should not
    crash the report)."""
    out: Dict[int, Dict[str, int]] = {}
    for rank, stacks in per_rank.items():
        buckets = out.setdefault(rank, {})
        for frames, count in stacks:
            phase = frames[0] if frames and frames[0] in PROF_PHASES \
                else "idle"
            buckets[phase] = buckets.get(phase, 0) + count
    return out


def top_frames(per_rank: Dict[int, List[Tuple[List[str], int]]],
               phase: Optional[str] = None, n: int = 5) -> List[Tuple[str, int]]:
    """Top-N leaf frames by sample count across every rank, optionally
    restricted to one phase."""
    counts: Dict[str, int] = {}
    for stacks in per_rank.values():
        for frames, count in stacks:
            if phase is not None and (not frames or frames[0] != phase):
                continue
            leaf = frames[-1] if frames else "-"
            counts[leaf] = counts.get(leaf, 0) + count
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:n]


def format_report(per_rank: Dict[int, List[Tuple[List[str], int]]],
                  top_n: int = 3) -> str:
    """Human report: the per-phase attribution table (one row per rank,
    one column per phase, sample counts with the dominant phase starred)
    plus each phase's top leaf frames. Empty input -> an explicit notice
    (the CI smoke greps for table content, never silence)."""
    if not per_rank:
        return "prof_report: no profiles found"
    table = phase_table(per_rank)
    phases = [p for p in PROF_PHASES
              if any(p in row for row in table.values())]
    if not phases:
        return "prof_report: no samples recorded"
    lines = ["Per-phase sample attribution (samples; * = rank's dominant "
             "phase):"]
    header = f"{'rank':>6} " + " ".join(f"{p:>9}" for p in phases) + \
        f" {'total':>9}"
    lines.append(header)
    for rank in sorted(table):
        row = table[rank]
        total = sum(row.values())
        dominant = max(row, key=row.get) if row else None
        cells = []
        for p in phases:
            v = row.get(p, 0)
            cells.append(f"{v}{'*' if p == dominant and v else ' ':>1}"
                         .rjust(9))
        lines.append(f"{rank:>6} " + " ".join(cells) + f" {total:>9}")
    for p in phases:
        tops = top_frames(per_rank, phase=p, n=top_n)
        if tops:
            hot = ", ".join(f"{frame} ({count})" for frame, count in tops)
            lines.append(f"  {p:>7} hot frames: {hot}")
    return "\n".join(lines)


def to_speedscope(per_rank: Dict[int, List[Tuple[List[str], int]]],
                  name: str = "hvdtpu profile") -> dict:
    """Speedscope file document (https://www.speedscope.app file-format):
    one sampled profile per rank over a shared frame table, each stack
    root-first with the phase and op as synthetic base frames."""
    frame_index: Dict[str, int] = {}
    frames: List[dict] = []

    def fidx(frame: str) -> int:
        if frame not in frame_index:
            frame_index[frame] = len(frames)
            frames.append({"name": frame})
        return frame_index[frame]

    profiles = []
    for rank in sorted(per_rank):
        samples: List[List[int]] = []
        weights: List[int] = []
        for stack, count in per_rank[rank]:
            samples.append([fidx(f) for f in stack])
            weights.append(count)
        profiles.append({
            "type": "sampled",
            "name": f"rank {rank}",
            "unit": "none",
            "startValue": 0,
            "endValue": sum(weights),
            "samples": samples,
            "weights": weights,
        })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "shared": {"frames": frames},
        "profiles": profiles,
    }


def main(argv=None) -> int:
    """The CLI (counterpart of the JAX package's ``scripts/prof_report.py``)::

        python -m horovod_tpu_torch.profiler DIR [-o merged.folded]
            [--speedscope doc.json] [--json table.json] [--require-samples]

    Merges DIR's ``prof.<rank>.folded`` files into one rank-prefixed
    folded file (flamegraph.pl-ready) and a speedscope document, and prints
    the per-phase table. Exit status: 0 on success; 2 with
    ``--require-samples`` when no rank recorded a sample."""
    import argparse
    import os
    import sys
    p = argparse.ArgumentParser(
        description="Merge per-rank sampling profiles + emit the per-phase "
                    "table")
    p.add_argument("prof_dir", help="directory of per-rank prof.<rank>.folded "
                                    "files (hvdrun --profile DIR)")
    p.add_argument("-o", "--merged", default=None,
                   help="write the merged rank-prefixed folded stacks here "
                        "(default: <dir>/profile_merged.folded)")
    p.add_argument("--speedscope", default=None,
                   help="write the speedscope document here (default: "
                        "<dir>/profile.speedscope.json)")
    p.add_argument("--no-merged", action="store_true",
                   help="analysis only; skip writing merged outputs")
    p.add_argument("--report", default=None,
                   help="write the text report here (default: stdout)")
    p.add_argument("--json", default=None,
                   help="write the machine-readable per-rank per-phase "
                        "table here")
    p.add_argument("--top", type=int, default=3,
                   help="hot leaf frames shown per phase (default 3)")
    p.add_argument("--require-samples", action="store_true",
                   help="exit 2 unless at least one rank recorded samples "
                        "(CI smoke gate)")
    args = p.parse_args(argv)

    per_rank = load_folded_dir(args.prof_dir)
    if not args.no_merged and per_rank:
        merged_path = args.merged or os.path.join(args.prof_dir,
                                                  "profile_merged.folded")
        with open(merged_path, "w") as f:
            f.write("\n".join(merge_ranks(per_rank)) + "\n")
        speed_path = args.speedscope or os.path.join(
            args.prof_dir, "profile.speedscope.json")
        with open(speed_path, "w") as f:
            json.dump(to_speedscope(per_rank), f)
        print(f"merged profile: {merged_path} (flamegraph.pl-ready), "
              f"{speed_path} (https://www.speedscope.app)", file=sys.stderr)

    text = format_report(per_rank, top_n=args.top)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    if args.json:
        table = {str(rank): phases
                 for rank, phases in phase_table(per_rank).items()}
        with open(args.json, "w") as f:
            json.dump({"version": 1, "ranks": table}, f, indent=2)

    total = sum(sum(row.values()) for row in phase_table(per_rank).values())
    if args.require_samples and total == 0:
        print("prof_report: no samples in any rank profile (is HVDTPU_PROF "
              "0, or did the job finish before the first tick?)",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
