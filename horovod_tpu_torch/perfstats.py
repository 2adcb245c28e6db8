"""Perf-attribution snapshot decoder + report helpers
(docs/observability.md "Live perf attribution").

The native core keeps always-on streaming statistics — EWMA plus P²-style
p50/p99 of op wall time and the wait/wire/reduce/codec phase buckets —
keyed by {tensor-set signature, algo, transport, hier, compression, op}
(``native/perfstats.{h,cpp}``), and a slowdown sentry that flags ops past
``HVDTPU_PERF_SLOWDOWN_PCT`` of their rolling baseline. This module is the
Python half:

* :func:`parse_snapshot` — decode one ``hvdtpu_perfstats_snapshot`` /
  ``/perfz`` JSON payload (validates the shape so a truncated scrape fails
  loudly);
* :func:`rank_summary` / :func:`find_straggler` — per-rank busy/phase
  aggregation and the live straggler pick, shared by ``hvdrun --top``
  (:mod:`horovod_tpu_torch.runner.hvdtop`) and ``hvd.perf_report()``;
* :func:`format_report` — a human-readable rendering of one rank's
  snapshot;
* :func:`load_profile` / :func:`merge_profile_dir` — the
  ``perf_profile.<rank>.json`` files each job persists at shutdown, merged
  into one ``perf_profile.json`` for the cross-run regression sentry
  (``python -m horovod_tpu_torch.perfstats``).

``PERF_PHASES`` mirrors ``hvdtpu::PerfPhase`` byte-for-byte (the ENUM-MIRROR
rule of the JAX package's invariant linter): the codes ride the ANOMALY
flight record's arg word across the C++/Python boundary.

The port's own copy of ``horovod_tpu/perfstats.py`` (it imports nothing of
the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

# Byte-for-byte mirror of hvdtpu::PerfPhase (native/perfstats.h).
PERF_PHASES = {"wall": 0, "wait": 1, "wire": 2, "reduce": 3, "codec": 4}
PHASE_NAMES = {v: k for k, v in PERF_PHASES.items()}

# Dominant-phase -> human attribution, the same vocabulary the offline
# trace analyzer uses (docs/tracing.md): a rank whose excess is WAIT is a
# victim (someone ELSE is late); WIRE is the transport; REDUCE/CODEC are
# this rank's own kernels; WALL is unattributed (e.g. descheduled).
ATTRIBUTION = {
    "wall": "compute-late",
    "wait": "peer-wait (compute-late elsewhere)",
    "wire": "wire-slow",
    "reduce": "reduce-bound",
    "codec": "quantize-bound",
}


def parse_snapshot(data) -> dict:
    """Decode one perfstats snapshot (bytes/str JSON) into a dict, with
    shape validation — a truncated or non-perfz payload raises
    ``ValueError`` instead of surfacing as weird KeyErrors downstream."""
    if isinstance(data, bytes):
        data = data.decode()
    try:
        snap = json.loads(data)
    except json.JSONDecodeError as exc:
        raise ValueError(f"not a perfstats snapshot: {exc}") from exc
    if not isinstance(snap, dict) or "keys" not in snap or \
            snap.get("version") != 1:
        raise ValueError("not a perfstats snapshot (missing version/keys)")
    for entry in snap["keys"]:
        for field in ("key", "count", "ewma_us", "p50_us", "p99_us"):
            if field not in entry:
                raise ValueError(
                    f"malformed perfstats key entry: missing {field!r}")
    return snap


def rank_summary(snap: dict) -> dict:
    """Aggregate one rank's snapshot into count-weighted per-phase means:

    ``{"ops": N, "busy_us": mean wall-wait, "phase_us": {phase: mean},
       "anomalies": int, "dominant": phase-name, "attribution": str}``

    ``dominant`` is the largest non-wall phase bucket (with the residual
    wall - sum(buckets) competing as "wall" = plain compute); the busy
    figure (own non-wait time per op) is what ranks are compared on — a
    victim waiting on a straggler shows high wall but LOW busy.
    """
    total = 0
    phase_sums = {name: 0.0 for name in PERF_PHASES}
    p99_sums = {"wall": 0.0, "wait": 0.0}
    anomalies = 0
    for entry in snap.get("keys", []):
        n = entry["count"]
        total += n
        for name in PERF_PHASES:
            phase_sums[name] += n * float(entry["ewma_us"].get(name, 0.0))
        for name in p99_sums:
            p99_sums[name] += n * float(entry["p99_us"].get(name, 0.0))
        anomalies += int(entry.get("anomalies", 0))
    if total == 0:
        return {"ops": 0, "busy_us": 0.0, "busy_p99_us": 0.0,
                "phase_us": {name: 0.0 for name in PERF_PHASES},
                "anomalies": anomalies, "dominant": "wall",
                "attribution": ATTRIBUTION["wall"]}
    phase_us = {name: phase_sums[name] / total for name in PERF_PHASES}
    busy = max(phase_us["wall"] - phase_us["wait"], 0.0)
    # p99-based busy: the EWMA forgets a one-off spike within ~tens of
    # ops, but the P² p99 tracks the top tail for ~1/(1-q) ≈ 100 samples —
    # so a RECENTLY slow rank stays visible to the console between
    # refreshes. Victims' p99 wall spikes too, but so does their p99 wait,
    # and the difference stays small.
    busy_p99 = max(p99_sums["wall"] / total - p99_sums["wait"] / total, 0.0)
    # Dominant: the biggest of the measured buckets vs the unexplained
    # remainder (compute and everything uninstrumented).
    other = max(phase_us["wall"] - sum(
        phase_us[p] for p in ("wait", "wire", "reduce", "codec")), 0.0)
    candidates = {"wire": phase_us["wire"], "reduce": phase_us["reduce"],
                  "codec": phase_us["codec"], "wait": phase_us["wait"],
                  "wall": other}
    dominant = max(candidates, key=lambda k: candidates[k])
    return {"ops": total, "busy_us": busy, "busy_p99_us": busy_p99,
            "phase_us": phase_us, "anomalies": anomalies,
            "dominant": dominant, "attribution": ATTRIBUTION[dominant]}


def find_straggler(per_rank: Dict[int, dict]) -> Optional[dict]:
    """The live straggler across per-rank snapshots: the rank with the
    highest own non-wait time per op (victims blocked on it show as
    waiting, docs/tracing.md). Returns ``{"rank", "busy_us", "dominant",
    "attribution", "anomalies"}`` or None when nothing has run yet."""
    best = None
    for rank, snap in sorted(per_rank.items()):
        summary = rank_summary(snap)
        if summary["ops"] == 0:
            continue
        # Rank on the larger of steady-state busy (EWMA) and recent-peak
        # busy (p99-based): a rank that was slow within the last ~100 ops
        # stays the straggler between console refreshes.
        score = max(summary["busy_us"], summary["busy_p99_us"])
        if best is None or score > best["busy_us"]:
            # The straggler's own excess is in its non-wait buckets; never
            # attribute the straggler to "waiting on peers".
            dominant = summary["dominant"] if summary["dominant"] != "wait" \
                else "wall"
            best = {"rank": rank, "busy_us": score,
                    "dominant": dominant,
                    "attribution": ATTRIBUTION[dominant],
                    "anomalies": summary["anomalies"]}
    return best


def format_report(snap: dict, top: int = 10) -> str:
    """Human-readable rendering of one rank's snapshot: the ``top`` keys by
    count-weighted wall time, their phase split, and anomaly counts."""
    lines = ["perf attribution (EWMA per op, microseconds):"]
    entries = sorted(snap.get("keys", []),
                     key=lambda e: e["count"] * e["ewma_us"].get("wall", 0),
                     reverse=True)
    header = (f"  {'key':<48} {'count':>7} {'wall':>9} {'wait':>8} "
              f"{'wire':>8} {'reduce':>8} {'codec':>8} {'p99':>9} anom")
    lines.append(header)
    for e in entries[:top]:
        ew = e["ewma_us"]
        lines.append(
            f"  {e['key'][:48]:<48} {e['count']:>7} "
            f"{ew.get('wall', 0):>9.0f} {ew.get('wait', 0):>8.0f} "
            f"{ew.get('wire', 0):>8.0f} {ew.get('reduce', 0):>8.0f} "
            f"{ew.get('codec', 0):>8.0f} "
            f"{e['p99_us'].get('wall', 0):>9.0f} "
            f"{e.get('anomalies', 0):>4}")
    if len(entries) > top:
        lines.append(f"  ... {len(entries) - top} more key(s)")
    summary = rank_summary(snap)
    lines.append(
        f"  ops={summary['ops']} busy={summary['busy_us']:.0f}us/op "
        f"dominant={summary['dominant']} ({summary['attribution']}) "
        f"anomalies={summary['anomalies']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cross-run profiles (perf_profile.<rank>.json -> perf_profile.json)
# ---------------------------------------------------------------------------

_PROFILE_FILE_RE = re.compile(r"^perf_profile\.(\d+)\.json$")


def load_profile(path: str) -> dict:
    """One profile file — either a per-rank ``perf_profile.<rank>.json``
    (native format: {"version", "rank", "size", "perfstats", "anomalies"})
    or a merged ``perf_profile.json`` ({"version", "ranks": {...}})."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != 1:
        raise ValueError(f"{path}: not a perf profile (version != 1)")
    return doc


def profile_ranks(doc: dict) -> Dict[int, dict]:
    """Normalize a profile document into {rank: per-rank profile}."""
    if "ranks" in doc:
        return {int(r): p for r, p in doc["ranks"].items()}
    return {int(doc.get("rank", 0)): doc}


def merge_profile_dir(path: str) -> Tuple[dict, List[int]]:
    """Merge every ``perf_profile.<rank>.json`` under ``path`` into one
    document; returns (merged, ranks found). Unparseable files are skipped
    (a rank that died mid-write must not take the merge down)."""
    ranks: Dict[str, dict] = {}
    found: List[int] = []
    for name in sorted(os.listdir(path)):
        m = _PROFILE_FILE_RE.match(name)
        if m is None:
            continue
        try:
            ranks[m.group(1)] = load_profile(os.path.join(path, name))
        except (ValueError, OSError, json.JSONDecodeError):
            continue
        found.append(int(m.group(1)))
    return {"version": 1, "ranks": ranks}, found


# ---------------------------------------------------------------------------
# the cross-run regression sentry (CLI)
# ---------------------------------------------------------------------------

def bootstrap_ci(ratios: list, resamples: int = 2000,
                 seed: int = 12345) -> tuple:
    """95% bootstrap CI on the median of ``ratios`` (resample-with-
    replacement medians, 2.5/97.5 percentiles; a fixed seed, so that the
    gate is reproducible from the same measurements)."""
    import random
    import statistics
    rng = random.Random(seed)
    meds = sorted(
        statistics.median(rng.choices(ratios, k=len(ratios)))
        for _ in range(resamples))
    lo = meds[max(0, int(0.025 * resamples) - 1)]
    hi = meds[min(resamples - 1, int(0.975 * resamples))]
    return lo, hi


def load_any(path: str) -> dict:
    """Profile file OR directory of perf_profile.<rank>.json files."""
    if os.path.isdir(path):
        merged, found = merge_profile_dir(path)
        if not found:
            raise ValueError(f"{path}: no perf_profile.<rank>.json files")
        return merged
    return load_profile(path)


def key_samples(doc: dict) -> Dict[Tuple[int, str], dict]:
    """{(rank, key): key-entry} across every rank in a profile document."""
    out: Dict[Tuple[int, str], dict] = {}
    for rank, prof in profile_ranks(doc).items():
        snap = prof.get("perfstats", {})
        for entry in snap.get("keys", []):
            out[(rank, entry["key"])] = entry
    return out


def ratio_ci(old: List[float], new: List[float], resamples: int = 2000,
             seed: int = 12345) -> Tuple[float, float, float]:
    """(median ratio, ci_lo, ci_hi) of median(new)/median(old), bootstrap
    over both sides. Deterministic seed: a CI gate must be reproducible."""
    import random
    import statistics
    rng = random.Random(seed)
    point = statistics.median(new) / max(statistics.median(old), 1e-9)
    ratios = sorted(
        statistics.median(rng.choices(new, k=len(new))) /
        max(statistics.median(rng.choices(old, k=len(old))), 1e-9)
        for _ in range(resamples))
    lo = ratios[max(0, int(0.025 * resamples) - 1)]
    hi = ratios[min(resamples - 1, int(0.975 * resamples))]
    return point, lo, hi


def anomaly_count(doc: dict) -> int:
    return sum(len(prof.get("anomalies", []))
               for prof in profile_ranks(doc).values())


def main(argv: Optional[List[str]] = None) -> int:
    """The cross-run regression sentry (counterpart of the JAX package's
    ``scripts/perf_diff.py``)::

        python -m horovod_tpu_torch.perfstats OLD NEW [--threshold-pct 10]

    OLD and NEW each name a merged ``perf_profile.json``, a per-rank file
    or a directory of per-rank files. Per key, the ratio of median wall
    times with a 95% bootstrap CI; "confirmed" means the CI's lower bound
    clears the threshold. Exit status: 0 no confirmed regression, 1 a
    confirmed regression, 2 bad arguments or unreadable profiles."""
    import argparse
    import statistics
    import sys
    p = argparse.ArgumentParser(description="Cross-run perf regression sentry")
    p.add_argument("old", help="baseline profile (file or directory)")
    p.add_argument("new", help="candidate profile (file or directory)")
    p.add_argument("--threshold-pct", type=float, default=10.0,
                   help="confirmed regression = CI lower bound above "
                        "1 + this percent (default 10)")
    p.add_argument("--min-samples", type=int, default=5,
                   help="per-key raw-sample floor on BOTH sides before the "
                        "key is compared (default 5)")
    p.add_argument("--json", default=None, metavar="FILE",
                   help="write the machine-readable comparison here")
    args = p.parse_args(argv)

    try:
        old_doc = load_any(args.old)
        new_doc = load_any(args.new)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"perf_diff: {exc}", file=sys.stderr)
        return 2

    old_keys = key_samples(old_doc)
    new_keys = key_samples(new_doc)
    threshold = 1.0 + args.threshold_pct / 100.0

    rows = []
    per_key_ratios = []
    confirmed: List[str] = []
    warned: List[str] = []
    for ident in sorted(set(old_keys) & set(new_keys)):
        o, n = old_keys[ident], new_keys[ident]
        so = [float(x) for x in o.get("samples_us", []) if x > 0]
        sn = [float(x) for x in n.get("samples_us", []) if x > 0]
        if len(so) < args.min_samples or len(sn) < args.min_samples:
            continue
        point, lo, hi = ratio_ci(so, sn)
        per_key_ratios.append(point)
        label = f"rank{ident[0]}:{ident[1]}"
        row = {"rank": ident[0], "key": ident[1], "ratio": round(point, 4),
               "ci95": [round(lo, 4), round(hi, 4)],
               "old_samples": len(so), "new_samples": len(sn),
               "old_p50_us": statistics.median(so),
               "new_p50_us": statistics.median(sn)}
        if lo > threshold:
            row["verdict"] = "REGRESSION"
            confirmed.append(label)
        elif point > threshold:
            row["verdict"] = "warn"  # slower, but the CI straddles
            warned.append(label)
        else:
            row["verdict"] = "ok"
        rows.append(row)

    overall = None
    if per_key_ratios:
        med = statistics.median(per_key_ratios)
        glo, ghi = bootstrap_ci(per_key_ratios)
        overall = {"median_ratio": round(med, 4),
                   "ci95": [round(glo, 4), round(ghi, 4)],
                   "keys": len(per_key_ratios)}
        if glo > threshold:
            confirmed.append("overall")

    old_anom, new_anom = anomaly_count(old_doc), anomaly_count(new_doc)
    report = {"threshold_pct": args.threshold_pct, "keys": rows,
              "overall": overall, "confirmed": confirmed, "warned": warned,
              "anomalies": {"old": old_anom, "new": new_anom}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)

    for row in rows:
        print(f"  [{row['verdict']:>10}] rank{row['rank']} {row['key']}: "
              f"{row['ratio']:.3f}x (CI {row['ci95'][0]:.3f}.."
              f"{row['ci95'][1]:.3f}, p50 {row['old_p50_us']:.0f} -> "
              f"{row['new_p50_us']:.0f} us)")
    if overall is not None:
        print(f"  overall: {overall['median_ratio']:.3f}x over "
              f"{overall['keys']} key(s) (CI {overall['ci95'][0]:.3f}.."
              f"{overall['ci95'][1]:.3f})")
    else:
        print("  overall: no comparable keys (profiles too short or "
              "disjoint)")
    if new_anom > old_anom:
        print(f"  note: anomaly log grew {old_anom} -> {new_anom} "
              "(see the profiles' \"anomalies\" entries)")
    if confirmed:
        print(f"perf_diff: CONFIRMED regression past "
              f"{args.threshold_pct:.0f}%: {', '.join(confirmed)}")
        return 1
    if warned:
        print(f"perf_diff: slower but unconfirmed (CI straddles): "
              f"{', '.join(warned)}")
    print("perf_diff: OK")
    return 0



if __name__ == "__main__":
    import sys
    sys.exit(main())
