"""``hvdrun --top`` — live per-rank fleet console (docs/observability.md).

The first time "why is rank 3 slow" is answerable MID-JOB without killing
it: the console scrapes every worker's ``/metrics`` and ``/perfz``
endpoints (the same secret-gated HTTP surface the aggregator uses) and
renders a refreshing frame of per-rank ops/s, wire ratio, stall/anomaly
flags, clock-sync quality, and the current straggler with its phase
attribution (:func:`horovod_tpu_torch.perfstats.find_straggler`).

No reference analog: upstream Horovod's only live surface is log lines.
``hvdtop-torch`` is the standalone CLI (point it at a running job);
``hvdrun --top`` embeds the same console in the launcher. ``--top-once``
renders a single frame non-interactively (the CI smoke gate).

The port's own copy of ``horovod_tpu/runner/hvdtop.py`` (it imports nothing
of the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..gradstats import parse_snapshot as parse_grad_snapshot
from ..gradstats import worst_snr
from ..observability import parse_prometheus_text, sample_value, scrape
from ..perfstats import find_straggler, parse_snapshot

# (timestamp, {rank: ops_total}) for the interval ops/s column.
FramePrev = Tuple[float, Dict[int, float]]


def scrape_rank(host: str, port: int,
                secret: Optional[str]) -> Tuple[Optional[dict],
                                                Optional[dict],
                                                Optional[dict]]:
    """(parsed /metrics, parsed /perfz, parsed /gradz) for one worker;
    all-None when unreachable, (parsed, None, None) when only the newer
    endpoints are absent (older build)."""
    try:
        parsed = parse_prometheus_text(
            scrape(host, port, secret=secret, timeout=3.0))
    except Exception:
        return None, None, None
    try:
        perf = parse_snapshot(
            scrape(host, port, path="/perfz", secret=secret, timeout=3.0))
    except Exception:
        perf = None
    try:
        grad = parse_grad_snapshot(
            scrape(host, port, path="/gradz", secret=secret, timeout=3.0))
    except Exception:
        grad = None
    return parsed, perf, grad


def scrape_all(endpoints: Dict[int, Tuple[str, int]],
               secret: Optional[str]
               ) -> Tuple[Dict[int, dict], Dict[int, dict], Dict[int, dict]]:
    from concurrent.futures import ThreadPoolExecutor

    metrics_by_rank: Dict[int, dict] = {}
    perf_by_rank: Dict[int, dict] = {}
    grad_by_rank: Dict[int, dict] = {}

    def one(item):
        rank, (host, port) = item
        return rank, scrape_rank(host, port, secret)

    with ThreadPoolExecutor(
            max_workers=min(16, max(1, len(endpoints)))) as pool:
        for rank, (parsed, perf, grad) in pool.map(one, endpoints.items()):
            if parsed is not None:
                metrics_by_rank[rank] = parsed
            if perf is not None:
                perf_by_rank[rank] = perf
            if grad is not None:
                grad_by_rank[rank] = grad
    return metrics_by_rank, perf_by_rank, grad_by_rank


def render_frame(endpoints: Dict[int, Tuple[str, int]],
                 metrics_by_rank: Dict[int, dict],
                 perf_by_rank: Dict[int, dict],
                 prev: Optional[FramePrev],
                 now: float,
                 grad_by_rank: Optional[Dict[int, dict]] = None
                 ) -> Tuple[str, FramePrev]:
    """One console frame (pure — the CI smoke and unit tests drive it with
    canned scrapes). Returns (text, new_prev)."""
    ops_now: Dict[int, float] = {}
    grad_by_rank = grad_by_rank or {}
    # Divergence convictions live on the coordinator's registry as
    # hvdtpu_divergence_total{suspect="R"}: collect every named suspect so
    # the MINORITY rank's row carries the DIV flag, not rank 0's.
    div_suspects: Dict[int, float] = {}
    for parsed in metrics_by_rank.values():
        for (suf, lbls, v) in parsed.get(
                "hvdtpu_divergence_total", {}).get("samples", []):
            if suf == "" and v > 0 and "suspect" in lbls:
                try:
                    r = int(lbls["suspect"])
                except ValueError:
                    continue
                div_suspects[r] = div_suspects.get(r, 0) + v
    header = (f"  {'rank':>4} {'host':<18} {'ops/s':>7} {'wire':>6} "
              f"{'anom':>5} {'clk±us':>7} {'stall':>5}  status")
    lines = [f"hvdtop — {len(metrics_by_rank)}/{len(endpoints)} ranks up "
             f"({time.strftime('%H:%M:%S', time.localtime())})", header]
    for rank in sorted(endpoints):
        host = endpoints[rank][0]
        parsed = metrics_by_rank.get(rank)
        if parsed is None:
            # A divergence conviction lives on the COORDINATOR's scrape, so
            # it can flag a rank whose own endpoint is down (a corrupted
            # rank may well be dying) — keep the DIV marker visible.
            status = "UNREACHABLE DIV" if div_suspects.get(rank, 0) > 0 \
                else "UNREACHABLE"
            lines.append(f"  {rank:>4} {host:<18} {'-':>7} {'-':>6} "
                         f"{'-':>5} {'-':>7} {'-':>5}  {status}")
            continue
        ops = sum(v for (suf, _l, v)
                  in parsed.get("hvdtpu_ops_total", {}).get("samples", [])
                  if suf == "")
        ops_now[rank] = ops
        rate = "n/a"
        if prev is not None and rank in prev[1]:
            dt = max(now - prev[0], 1e-9)
            rate = f"{max(ops - prev[1][rank], 0.0) / dt:.1f}"
        raw = sample_value(parsed, "hvdtpu_allreduce_raw_bytes_total") or 0
        wire = sample_value(parsed, "hvdtpu_allreduce_wire_bytes_total") or 0
        ratio = f"{raw / wire:.2f}x" if wire > 0 else "1.00x"
        anomalies = sum(
            v for (suf, _l, v) in parsed.get(
                "hvdtpu_perf_anomalies_total", {}).get("samples", [])
            if suf == "")
        clock_err = sample_value(parsed, "hvdtpu_clock_err_us")
        clk = "n/a" if clock_err is None or clock_err < 0 else \
            f"{clock_err:.0f}"
        stalled = (sample_value(parsed, "hvdtpu_stalled") or 0) > 0
        flags = []
        if anomalies:
            flags.append("ANOM")
        if stalled:
            flags.append("STALL")
        if clock_err is not None and clock_err > 10000:
            flags.append("CLKDRIFT")  # alignment degraded past 10 ms
        # Numerical health (docs/numerics.md): NAN = this rank saw
        # non-finite gradient elements; DIV = the divergence probe
        # convicted this rank's post-allreduce output as the minority.
        if (sample_value(parsed, "hvdtpu_nonfinite_grads_total") or 0) > 0:
            flags.append("NAN")
        if div_suspects.get(rank, 0) > 0:
            flags.append("DIV")
        lines.append(
            f"  {rank:>4} {host:<18} {rate:>7} {ratio:>6} "
            f"{int(anomalies):>5} {clk:>7} {'yes' if stalled else 'no':>5}"
            f"  {' '.join(flags) if flags else 'ok'}")
    straggler = find_straggler(perf_by_rank)
    if straggler is not None:
        lines.append(
            f"  straggler: rank {straggler['rank']} "
            f"({straggler['busy_us']:.0f}us busy/op, "
            f"{straggler['attribution']}"
            + (f", {straggler['anomalies']} anomalies" if
               straggler["anomalies"] else "") + ")")
    else:
        lines.append("  straggler: n/a (no /perfz data yet)")
    # Worst compressed-layer SNR across the fleet (docs/numerics.md
    # "SNR-guided compression selection"): the layer quantization hurts
    # most right now, and on which rank.
    worst = None
    for rank, grad in sorted(grad_by_rank.items()):
        w = worst_snr(grad)
        if w is not None and (worst is None or w["snr_db"] < worst[1]["snr_db"]):
            worst = (rank, w)
    if worst is not None:
        lines.append(
            f"  worst SNR: {worst[1]['key']} at {worst[1]['snr_db']:.1f} dB "
            f"({worst[1]['compression']}, rank {worst[0]})")
    return "\n".join(lines), (now, ops_now)


class TopConsole:
    """The ``--top`` refresh loop. ``once=True`` waits until one frame has
    every rank answering (or ``once_timeout`` elapses), prints that single
    frame, and stops — the non-interactive CI mode."""

    def __init__(self, endpoints: Dict[int, Tuple[str, int]],
                 secret: Optional[str] = None, interval_s: float = 2.0,
                 once: bool = False, once_timeout: float = 60.0, out=None):
        self._endpoints = dict(endpoints)
        self._secret = secret
        self._interval = interval_s
        self._once = once
        self._once_timeout = once_timeout
        self._out = out if out is not None else sys.stderr
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Optional[FramePrev] = None
        # once mode: best frame so far ((ranks answering, has straggler),
        # text) — printed at the deadline or when the job ends before a
        # complete frame was seen.
        self._best: Tuple[Tuple[int, int], str] = ((-1, -1), "")
        self._print_lock = threading.Lock()
        self._printed_once = False

    def frame(self) -> Tuple[str, int, bool]:
        """Scrape + render one frame; returns (text, ranks answering,
        straggler attributed)."""
        metrics_by_rank, perf_by_rank, grad_by_rank = scrape_all(
            self._endpoints, self._secret)
        text, self._prev = render_frame(self._endpoints, metrics_by_rank,
                                        perf_by_rank, self._prev,
                                        time.monotonic(),
                                        grad_by_rank=grad_by_rank)
        return text, len(metrics_by_rank), \
            find_straggler(perf_by_rank) is not None

    def _print_once(self, text: str) -> None:
        # stop() (launcher thread) and _loop (console thread) can race to
        # print the final once-mode frame; exactly one must win.
        with self._print_lock:
            if self._printed_once:
                return
            self._printed_once = True
        print(text, file=self._out, flush=True)

    def _loop(self) -> None:
        deadline = time.monotonic() + self._once_timeout
        is_tty = hasattr(self._out, "isatty") and self._out.isatty()
        while not self._stop.is_set():
            text, up, attributed = self.frame()
            if self._once:
                # Hold for a COMPLETE frame — every rank answering AND a
                # straggler attributed (/perfz needs at least one finished
                # op, which can lag the metrics servers coming up); at the
                # deadline (or when stop() fires first because the job
                # ended) print the BEST frame seen rather than nothing.
                score = (up, 1 if attributed else 0)
                if score > self._best[0]:
                    self._best = (score, text)
                if (up >= len(self._endpoints) and attributed) or \
                        time.monotonic() >= deadline:
                    self._print_once(self._best[1])
                    return
                if self._stop.wait(min(1.0, self._interval)):
                    return
                continue
            if is_tty:
                print("\x1b[2J\x1b[H" + text, file=self._out, flush=True)
            else:
                print(text, file=self._out, flush=True)
            if self._stop.wait(self._interval):
                return

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._once and self._best[0][0] >= 0:
            self._print_once(self._best[1])

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the loop finishes (``once`` mode prints and exits)."""
        if self._thread:
            self._thread.join(timeout=timeout)


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone CLI (``hvdtop-torch``): watch a running job's workers.

        hvdtop-torch --host H --port BASE -np N [--secret-env HVDTPU_SECRET]
        python -m horovod_tpu_torch.runner.hvdtop ...
    """
    import argparse
    import os

    p = argparse.ArgumentParser(
        prog="hvdtop-torch",
        description="Live per-rank console for a running horovod_tpu_torch "
                    "job "
                    "(scrapes each worker's /metrics + /perfz; "
                    "docs/observability.md)")
    p.add_argument("--host", default="127.0.0.1",
                   help="worker host (single-host jobs; for multi-host use "
                        "--endpoints)")
    p.add_argument("--port", type=int, default=None,
                   help="metrics BASE port (HVDTPU_METRICS_PORT; rank r "
                        "serves on base+r); required unless --endpoints")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="world size; required unless --endpoints")
    p.add_argument("--endpoints", default=None,
                   help='explicit "rank=host:port,..." list overriding '
                        "--host/--port")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (non-interactive)")
    p.add_argument("--once-timeout", type=float, default=60.0)
    p.add_argument("--secret-env", default="HVDTPU_SECRET",
                   help="env var holding the job secret (never a flag: "
                        "secrets must not land in `ps` output)")
    args = p.parse_args(argv)
    if args.endpoints:
        endpoints = {}
        for part in args.endpoints.split(","):
            rank_s, _, addr = part.partition("=")
            host, _, port_s = addr.rpartition(":")
            endpoints[int(rank_s)] = (host, int(port_s))
    else:
        if args.port is None or args.num_proc is None:
            p.error("--port and -np are required unless --endpoints is "
                    "given")
        endpoints = {r: (args.host, args.port + r)
                     for r in range(args.num_proc)}
    console = TopConsole(endpoints, secret=os.environ.get(args.secret_env)
                         or None, interval_s=args.interval, once=args.once,
                         once_timeout=args.once_timeout, out=sys.stdout)
    console.start()
    try:
        console.wait()
    except KeyboardInterrupt:
        pass
    finally:
        console.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
