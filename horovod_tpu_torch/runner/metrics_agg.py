"""Driver-side metrics aggregation for ``hvdrun``.

No reference analog: the reference's driver is launch-and-wait only, and its
runtime visibility is the post-hoc timeline. Here the launcher scrapes every
worker's ``/metrics`` endpoint (``HVDTPU_METRICS_PORT`` base + rank, secret
proof attached), serves a merged world-level ``/metrics`` on
``base + world_size`` — every per-rank sample re-labeled with ``rank="r"``
so one Prometheus scrape of the driver sees the whole job — and prints a
periodic one-line summary (step rate, wire compression ratio, slowest rank,
stall flags) to stderr.

The port's own copy of ``horovod_tpu/runner/metrics_agg.py`` (it imports
nothing of the JAX package); the two are held to the same outputs on the
same input (``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..observability import (MetricsServer, parse_prometheus_text,
                             sample_value, scrape)

# Greedy label block (matches observability.py's parser): a sample's value
# never contains '}', so everything up to the LAST '}' is the label set —
# the non-greedy [^}]* variant would skip samples whose label VALUES contain
# '}' (legal under the exposition escaping rules) and leave them un-ranked.
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?(\s+\S+)$')


def relabel_with_rank(text: str, rank: int) -> str:
    """Inject ``rank="r"`` into every sample line of an exposition dump
    (comment lines pass through untouched)."""
    out: List[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            out.append(line)
            continue
        name, labels, rest = m.group(1), m.group(2), m.group(3)
        if labels:
            labels = labels[:-1] + f',rank="{rank}"}}'
        else:
            labels = f'{{rank="{rank}"}}'
        out.append(name + labels + rest)
    return "\n".join(out) + "\n"


def merge_dumps(dumps: Dict[int, str]) -> str:
    """Merge per-rank dumps into one world-level exposition: every sample
    gains a ``rank`` label, and all samples of a family stay in ONE
    contiguous group under a single # HELP/# TYPE header (the exposition
    format forbids interleaving a family's lines with other families —
    strict consumers like promtool reject rank-by-rank concatenation).

    Per-rank dumps are already family-grouped (native Dump() is sorted and
    deterministic), so each is split into blocks at # HELP boundaries and
    the blocks are re-joined family by family, ranks in order.
    """
    order: List[str] = []           # family names, first-seen order
    meta: Dict[str, List[str]] = {}     # family -> its # HELP/# TYPE lines
    samples: Dict[str, List[str]] = {}  # family -> relabeled sample lines

    for rank in sorted(dumps):
        family = ""
        for line in relabel_with_rank(dumps[rank], rank).splitlines():
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    family = parts[2]
                if family not in meta:
                    order.append(family)
                    meta[family] = []
                    samples[family] = []
                if line not in meta[family]:
                    meta[family].append(line)
                continue
            if family not in meta:  # headerless dump (hand-rolled text)
                order.append(family)
                meta[family] = []
                samples[family] = []
            samples[family].append(line)

    out: List[str] = []
    for family in order:
        out.extend(meta[family])
        out.extend(samples[family])
    return "\n".join(out) + ("\n" if out else "")


# Per-rank snapshot the summary differences between rounds:
# (timestamp, {rank: ops_total}, {rank: (op_seconds_sum, op_count)}).
SummaryPrev = Tuple[float, Dict[int, float], Dict[int, Tuple[float, float]]]


def histogram_quantile(parsed_by_rank: Dict[int, dict], name: str,
                       q: float) -> Optional[float]:
    """Quantile of a native histogram merged across ranks: sum the
    per-(rank, le) bucket counts, then linearly interpolate inside the
    first bucket whose cumulative count crosses ``q`` (the standard
    Prometheus ``histogram_quantile`` estimate). None when no
    observations exist."""
    buckets: Dict[float, float] = {}
    for parsed in parsed_by_rank.values():
        for suf, lbls, value in parsed.get(name, {}).get("samples", []):
            if suf != "bucket":
                continue
            le = lbls.get("le", "")
            bound = float("inf") if le == "+Inf" else float(le)
            buckets[bound] = buckets.get(bound, 0.0) + value
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]  # cumulative: +Inf holds the count
    if total <= 0:
        return None
    if len(bounds) == 1:
        # A lone +Inf bucket carries a count but ZERO bound information —
        # interpolating from an implicit 0.0 would report "p50 = 0s" for a
        # histogram whose every observation might be minutes. Promtool's
        # histogram_quantile returns NaN here; None is our spelling.
        return None if bounds[0] == float("inf") else bounds[0]
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for b in bounds:
        cum = buckets[b]
        if cum >= target:
            if b == float("inf"):
                return prev_bound  # best lower bound we have
            if cum == prev_cum:
                return b
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (b - prev_bound)
        prev_bound, prev_cum = b, cum
    return bounds[-1] if bounds[-1] != float("inf") else prev_bound


def summarize(parsed_by_rank: Dict[int, dict],
              prev: Optional[SummaryPrev],
              now: float,
              unreachable: Optional[List[int]] = None
              ) -> Tuple[str, SummaryPrev]:
    """One-line job summary from per-rank parsed metrics.

    The op rate and the slowest-rank ms/op are INTERVAL deltas against
    ``prev`` (a rank slow only during warmup must not be reported slowest
    forever), computed per rank and only over ranks present in both
    snapshots (a failed scrape must not dent the rate, then spike it when
    the worker returns). Wire ratio and stall flags are levels. Returns
    (line, new_prev).
    """
    ops_now: Dict[int, float] = {}
    opsec_now: Dict[int, Tuple[float, float]] = {}
    raw = wire = 0.0
    failures = zc_sends = zc_fallbacks = 0.0
    stalled: List[int] = []
    for rank, parsed in sorted(parsed_by_rank.items()):
        ops_now[rank] = sum(
            v for (suf, _l, v) in parsed.get("hvdtpu_ops_total",
                                             {}).get("samples", [])
            if suf == "")
        raw += sample_value(parsed, "hvdtpu_allreduce_raw_bytes_total") or 0
        wire += sample_value(parsed, "hvdtpu_allreduce_wire_bytes_total") or 0
        failures += sample_value(parsed,
                                 "hvdtpu_failures_detected_total") or 0
        zc_sends += sample_value(parsed, "hvdtpu_zerocopy_sends_total") or 0
        zc_fallbacks += sample_value(parsed,
                                     "hvdtpu_zerocopy_fallbacks_total") or 0
        if (sample_value(parsed, "hvdtpu_stalled") or 0) > 0:
            stalled.append(rank)
        secs = sum(v for (suf, _l, v) in
                   parsed.get("hvdtpu_op_seconds", {}).get("samples", [])
                   if suf == "sum")
        count = sum(v for (suf, lbl, v) in
                    parsed.get("hvdtpu_op_seconds", {}).get("samples", [])
                    if suf == "bucket" and lbl.get("le") == "+Inf")
        opsec_now[rank] = (secs, count)

    rate = float("nan")
    slowest_rank, slowest_avg = None, -1.0
    if prev is not None:
        t0, ops_prev, opsec_prev = prev
        dt = max(now - t0, 1e-9)
        rate = sum(ops_now[r] - ops_prev[r]
                   for r in ops_now if r in ops_prev)
        rate = max(rate, 0.0) / dt
        for r, (secs, count) in opsec_now.items():
            if r not in opsec_prev:
                continue
            dsecs = secs - opsec_prev[r][0]
            dcount = count - opsec_prev[r][1]
            if dcount > 0 and dsecs / dcount > slowest_avg:
                slowest_avg, slowest_rank = dsecs / dcount, r
    else:
        # First round: no interval yet — fall back to lifetime averages.
        for r, (secs, count) in opsec_now.items():
            if count > 0 and secs / count > slowest_avg:
                slowest_avg, slowest_rank = secs / count, r
    ratio = raw / wire if wire > 0 else 1.0
    parts = [
        f"ops/s={rate:.1f}" if rate == rate else "ops/s=n/a",
        f"wire_ratio={ratio:.2f}x",
        (f"slowest=rank{slowest_rank}({slowest_avg * 1e3:.1f}ms/op)"
         if slowest_rank is not None else "slowest=n/a"),
        f"stalled={stalled if stalled else '[]'}",
        # Reliability + zero-copy counters the one-liner predates:
        # cumulative failure detections, elastic-recovery p50, and the
        # zero-copy engagement rate of large TCP sends (off = no TCP lane
        # tried the engine — all-shm worlds, zero large sends).
        f"failures={int(failures)}",
    ]
    p50 = histogram_quantile(parsed_by_rank, "hvdtpu_recovery_seconds", 0.5)
    if p50 is not None:
        parts.append(f"recovery_p50={p50:.2f}s")
    # Skip-and-flag, never lose the cycle: a worker that died (or is being
    # replaced by elastic re-rendezvous) mid-scrape is NAMED while the
    # reachable ranks' summary keeps flowing (docs/metrics.md).
    if unreachable:
        parts.append(f"unreachable={sorted(unreachable)}")
    anomalies = sum(
        v for parsed in parsed_by_rank.values()
        for (suf, _l, v) in parsed.get("hvdtpu_perf_anomalies_total",
                                       {}).get("samples", [])
        if suf == "")
    if anomalies:
        parts.append(f"perf_anomalies={int(anomalies)}")
    zc_total = zc_sends + zc_fallbacks
    parts.append(
        f"zc={100.0 * zc_sends / zc_total:.0f}%"
        f"({int(zc_sends)}zc/{int(zc_fallbacks)}cp)"
        if zc_total > 0 else "zc=off")
    return "hvdrun metrics: " + " ".join(parts), (now, ops_now, opsec_now)


class MetricsAggregator:
    """Scrape-all-workers loop + merged world ``/metrics`` endpoint.

    ``endpoints`` maps rank -> (host, port). The aggregator tolerates
    unreachable workers (they drop out of the merged view until the next
    successful scrape — a dead rank must not take the job's observability
    down with it).
    """

    def __init__(self, endpoints: Dict[int, Tuple[str, int]],
                 port: int = 0, secret: Optional[str] = None,
                 interval_s: float = 10.0, print_summary: bool = True,
                 out=None):
        self._endpoints = dict(endpoints)
        self._secret = secret
        self._interval = interval_s
        self._print = print_summary
        self._out = out if out is not None else sys.stderr
        self._merged = ""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Optional[SummaryPrev] = None
        self._unreachable: List[int] = []
        self._server = MetricsServer(dump_fn=self.merged, port=port,
                                     secret=secret,
                                     health={"role": "driver",
                                             "workers": len(endpoints)})

    @property
    def port(self) -> int:
        return self._server.port

    def merged(self) -> str:
        with self._lock:
            return self._merged

    def unreachable(self) -> List[int]:
        """Ranks whose endpoint did not answer the LAST scrape round —
        dead, mid-exit, or being replaced by elastic re-rendezvous."""
        with self._lock:
            return list(self._unreachable)

    def update_endpoints(self, endpoints: Dict[int, Tuple[str, int]]) -> None:
        """Swap the scrape targets (elastic re-rendezvous moves ranks to
        new hosts/ports); takes effect on the next round. The summary's
        interval deltas only compare ranks present in consecutive rounds,
        so a replaced rank restarts its rate cleanly instead of spiking."""
        with self._lock:
            self._endpoints = dict(endpoints)

    def scrape_once(self) -> Dict[int, str]:
        """One pass over every worker; refreshes the merged dump and
        returns the raw per-rank texts (ranks that failed are absent).
        Workers are scraped concurrently so a handful of dead endpoints
        (3 s timeout each) cannot push one round past the summary interval
        and stale the merged view exactly when the operator needs it."""
        from concurrent.futures import ThreadPoolExecutor

        def one(item):
            rank, (host, port) = item
            try:
                return rank, scrape(host, port, secret=self._secret,
                                    timeout=3.0)
            except Exception:
                return rank, None  # not up yet / mid-exit: skip this round

        with self._lock:
            endpoints = dict(self._endpoints)
        with ThreadPoolExecutor(
                max_workers=min(16, max(1, len(endpoints)))) as pool:
            results = list(pool.map(one, endpoints.items()))
        dumps = {rank: text for rank, text in results if text is not None}
        with self._lock:
            self._merged = merge_dumps(dumps)
            self._unreachable = sorted(set(endpoints) - set(dumps))
        return dumps

    def summary_line(self, dumps: Dict[int, str]) -> str:
        parsed = {}
        for r, t in dumps.items():
            try:
                parsed[r] = parse_prometheus_text(t)
            except ValueError:
                # A worker dying MID-RESPONSE hands us a truncated dump:
                # flag it like an unreachable rank instead of losing the
                # whole cycle to one parse error.
                with self._lock:
                    if r not in self._unreachable:
                        self._unreachable.append(r)
        line, self._prev = summarize(parsed, self._prev, time.monotonic(),
                                     unreachable=self.unreachable())
        return line

    def _loop(self) -> None:
        # Scrape-then-wait (not wait-then-scrape): the merged endpoint is
        # advertised at launch, so it must populate as soon as workers come
        # up, not one full --metrics-interval later. While no worker has
        # answered yet (job still booting), retry on a short warmup period
        # instead of sleeping out a potentially long interval.
        while not self._stop.is_set():
            dumps = self.scrape_once()
            if self._print and dumps:
                print(self.summary_line(dumps), file=self._out, flush=True)
            wait = self._interval if dumps else min(1.0, self._interval)
            if self._stop.wait(wait):
                return

    def start(self) -> None:
        self._server.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self._server.stop()
