"""Live observability: per-worker ``/metrics`` endpoint + exposition tools.

The native core instruments itself through the lock-free registry in
``native/metrics.{h,cpp}`` (coordination tick latency, negotiation queue
depth, fusion utilization, per-op latency/bytes histograms labeled by
algo/transport/compression/dtype, stall state, autotune gauges, cumulative
raw/wire byte counters). This module is the Python half of the subsystem:

* :func:`parse_prometheus_text` — exposition-format parser used by
  ``hvd.metrics()``, the driver aggregator, and the tests;
* :class:`MetricsServer` — the per-worker HTTP endpoint (``/metrics`` +
  ``/healthz``), secret-gated with the same HMAC proof header as the
  rendezvous KV server (reference: ``secret.py`` + the authenticated
  driver service);
* :func:`scrape` — the matching HTTP client.

The reference has no analog: its only runtime visibility is the post-hoc
Chrome-trace timeline. See ``docs/metrics.md`` for the metric catalog.

The port's own copy of ``horovod_tpu/observability.py`` (it imports nothing
of the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import json
import re
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from .runner.http_kv import _AUTH_HEADER, _sign

# Sample line: name, optional {labels}, value. Timestamps are not emitted by
# the native dumper, so they are not accepted.
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace('\\n', '\n').replace('\\"', '"').replace('\\\\', '\\')


def _parse_labels(block: Optional[str]) -> Dict[str, str]:
    if not block:
        return {}
    return {k: _unescape(v) for k, v in _LABEL_RE.findall(block)}


def parse_prometheus_text(text: str) -> dict:
    """Parse Prometheus text exposition (format 0.0.4) into

    ``{family: {"type": str, "help": str,
                "samples": [(suffix, labels_dict, value)]}}``

    where ``suffix`` is ``""`` for plain counter/gauge samples and
    ``"bucket"``/``"sum"``/``"count"`` for histogram children (attached to
    their base family, the ``le`` label left in place).
    """
    families: Dict[str, dict] = {}

    def family(name: str) -> dict:
        return families.setdefault(
            name, {"type": "untyped", "help": "", "samples": []})

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                family(parts[2])["type"] = parts[3] if len(parts) > 3 else ""
            elif len(parts) >= 3 and parts[1] == "HELP":
                family(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed exposition line: {line!r}")
        name, labels_block, value = m.group(1), m.group(2), m.group(3)
        suffix = ""
        base = name
        for s in ("_bucket", "_sum", "_count"):
            stem = name[:-len(s)] if name.endswith(s) else None
            if stem and families.get(stem, {}).get("type") == "histogram":
                base, suffix = stem, s[1:]
                break
        family(base)["samples"].append(
            (suffix, _parse_labels(labels_block), float(value)))
    return families


def _escape(v: str) -> str:
    return v.replace('\\', '\\\\').replace('"', '\\"').replace('\n', '\\n')


def _render_value(v: float) -> str:
    if v != v:  # NaN is legal exposition (promtool parity, metrics_agg)
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)  # shortest round-trip


def render_exposition(families: dict) -> str:
    """Re-render a :func:`parse_prometheus_text` result back into the text
    exposition format (one # HELP/# TYPE header per family, samples in
    parsed order). ``parse(render(parse(text)))`` equals ``parse(text)``
    for every dump the native registry produces — the golden round-trip
    contract tests/test_metrics.py pins against a live worker's full
    ``/metrics`` catalog."""
    out: List[str] = []
    for name, fam in families.items():
        if fam.get("help"):
            out.append(f"# HELP {name} {fam['help']}")
        if fam.get("type") and fam["type"] != "untyped":
            out.append(f"# TYPE {name} {fam['type']}")
        for suffix, labels, value in fam.get("samples", []):
            sample_name = name + (f"_{suffix}" if suffix else "")
            block = ""
            if labels:
                block = "{" + ",".join(
                    f'{k}="{_escape(v)}"' for k, v in labels.items()) + "}"
            out.append(f"{sample_name}{block} {_render_value(value)}")
    return "\n".join(out) + ("\n" if out else "")


def sample_value(parsed: dict, name: str, suffix: str = "",
                 **labels) -> Optional[float]:
    """First sample of ``name`` whose labels include ``labels`` (None if
    absent) — convenience for tests and the driver summary."""
    fam = parsed.get(name)
    if not fam:
        return None
    for suf, lbls, value in fam["samples"]:
        if suf != suffix:
            continue
        if all(lbls.get(k) == v for k, v in labels.items()):
            return value
    return None


# The per-worker observability surface as ONE path registry: every
# endpoint rides the same HMAC gate and the same keep-alive error
# handling, and adding a surface is one row here plus one source
# callable — not a copy of the handler boilerplate. Rows:
# path -> (content type, server attribute holding the source callable).
# Every source callable takes the raw query string (most ignore it; /profz
# reads ?start/?stop) — the MetricsServer ctor adapts query-less sources,
# so the handler needs no per-path cases. A registered path whose source is
# None (subsystem absent) answers 404, exactly like an unknown path — the
# parameterized auth suite in tests/test_security.py walks this table.
ENDPOINT_PATHS = {
    "/metrics": ("text/plain; version=0.0.4; charset=utf-8",
                 "metrics_dump_fn"),
    "/healthz": ("application/json", "metrics_health_fn"),
    # Flight-recorder live view (docs/fault-tolerance.md): the in-flight
    # op + last-N phase events, decoded from an in-memory ring snapshot.
    "/debugz": ("application/json", "metrics_debugz_fn"),
    # Live perf attribution (docs/observability.md): the streaming per-key
    # baselines + anomaly counts as JSON.
    "/perfz": ("application/json", "metrics_perfz_fn"),
    # Numerical health (docs/numerics.md): per-tensor gradient norms,
    # per-key quantization SNR, NaN/divergence totals as JSON.
    "/gradz": ("application/json", "metrics_gradz_fn"),
    # Sampling profiler (docs/profiling.md): folded-stacks JSON;
    # ?start / ?stop open and close the sampling window.
    "/profz": ("application/json", "metrics_profz_fn"),
}


class _MetricsHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # silence
        pass

    def _authorized(self) -> bool:
        secret = getattr(self.server, "metrics_secret", None)
        if not secret:
            return True
        import hmac as _hmac
        proof = self.headers.get(_AUTH_HEADER, "")
        # The proof binds the FULL request target (query string included),
        # so an authed /profz scrape cannot be replayed as /profz?stop.
        expect = _sign(secret, self.command, self.path, b"")
        if _hmac.compare_digest(proof, expect):
            return True
        self.send_response(403)
        self.end_headers()
        return False

    def do_GET(self):
        if not self._authorized():
            return
        path, _, query = self.path.partition("?")
        row = ENDPOINT_PATHS.get(path)
        fn = getattr(self.server, row[1], None) if row else None
        if fn is None:  # unknown path, or a registered one with no source
            self.send_response(404)
            self.end_headers()
            return
        try:
            body = fn(query).encode()
        except Exception as exc:  # keep the endpoint alive
            self.send_response(500)
            self.end_headers()
            self.wfile.write(str(exc).encode())
            return
        self.send_response(200)
        self.send_header("Content-Type", row[0])
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsServer:
    """Threaded HTTP server for one worker's observability endpoints
    (``ENDPOINT_PATHS``: /metrics, /healthz, /debugz, /perfz, /profz,
    /gradz).

    ``dump_fn()`` returns the exposition text (the native registry dump);
    ``health`` is a static dict merged into the ``/healthz`` JSON (rank,
    size, ...). ``profz_fn(query)`` receives the raw query string so
    ``?start``/``?stop`` drive the sampling window. With ``secret`` set,
    requests must carry the same HMAC proof header the KV store uses —
    unauthenticated scrapes get 403 on every path.
    """

    def __init__(self, dump_fn: Callable[[], str], port: int = 0,
                 secret: Optional[str] = None,
                 health: Optional[dict] = None,
                 debugz_fn: Optional[Callable[[], str]] = None,
                 perfz_fn: Optional[Callable[[], str]] = None,
                 profz_fn: Optional[Callable[[str], str]] = None,
                 gradz_fn: Optional[Callable[[], str]] = None):
        self._server = ThreadingHTTPServer(("0.0.0.0", port),
                                           _MetricsHandler)

        def ignore_query(fn):
            # Adapt a query-less source to the registry's uniform
            # fn(query) -> str contract (None stays None -> 404).
            return None if fn is None else (lambda query, _f=fn: _f())

        srv = self._server
        srv.metrics_secret = secret  # type: ignore[attr-defined]
        srv.metrics_dump_fn = ignore_query(dump_fn)  # type: ignore[attr-defined]
        srv.metrics_health_fn = (  # type: ignore[attr-defined]
            lambda query: json.dumps(dict(health or {}, status="ok")))
        # Subsystem sources; None = that path 404s (ENDPOINT_PATHS).
        srv.metrics_debugz_fn = ignore_query(debugz_fn)  # type: ignore[attr-defined]
        srv.metrics_perfz_fn = ignore_query(perfz_fn)  # type: ignore[attr-defined]
        srv.metrics_profz_fn = profz_fn  # type: ignore[attr-defined]
        srv.metrics_gradz_fn = ignore_query(gradz_fn)  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        # stop() waits for the loop to see its request, up to one poll
        # interval (0.5 s by default): an elastic recovery stops the
        # server in its reinit, so the loop polls every 50 ms.
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # shutdown() blocks on the serve_forever loop's acknowledgment, so
        # only call it when start() actually ran.
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
        self._server.server_close()


def scrape(addr: str, port: int, path: str = "/metrics",
           secret: Optional[str] = None, timeout: float = 5.0) -> str:
    """GET one endpoint, with the HMAC proof header when ``secret`` is set.
    Raises ``urllib.error.HTTPError`` (403 on bad/missing proof)."""
    headers = {}
    if secret:
        headers[_AUTH_HEADER] = _sign(secret, "GET", path, b"")
    req = urllib.request.Request(f"http://{addr}:{port}{path}",
                                 headers=headers)
    return urllib.request.urlopen(req, timeout=timeout).read().decode()


def worker_metrics_endpoints(hostnames: List[str],
                             base_port: int) -> List[Tuple[str, int]]:
    """(host, port) per rank for a static launch: worker rank r serves on
    ``base_port + r`` on its own host (0 = metrics disabled -> empty)."""
    if base_port <= 0:
        return []
    return [(host, base_port + r) for r, host in enumerate(hostnames)]
