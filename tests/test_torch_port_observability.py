"""The port's observability layer against the JAX package's, on the CPU.

Three jobs run once for the module, two at a time, each under its own
launcher and deadline (``JOB_DEADLINE``):

* ``port``: ``hvdrun-torch -np 2`` with every observability flag
  (``--metrics-port`` on a free base, ``--debugz``, ``--top --top-once``,
  ``--trace DIR --trace-sample 1``, ``--perf-profile``, ``--grad-profile``,
  ``--profile`` on the wall clock, ``--postmortem``) and the core's int8
  wire compression.
  Its two process-mode ranks run ``OPS`` (allreduces on values from a
  numpy seed, a broadcast, an allgather), scrape their own endpoints with
  the job's secret and without it, take every snapshot of their core, and
  rank 0 runs ``hvdtop-torch --once`` against the live job. The ranks end
  with ``hvd.shutdown()`` alone.
* ``jax``: the JAX package's ``hvdrun`` with the same flags and the same
  ops on its own core.
* ``hang``: ``hvdrun-torch -np 2 --postmortem DIR`` with rank 1 hung by
  the chaos knobs at its third op; rank 0 trips the read deadline and the
  launcher prints the verdict.

Then: the launcher's outputs and merged artifacts; every endpoint served
with the secret (200) and refused without it (403); the live cores'
metric families equal in name, type and label keys, and their op counters
equal; every parser of the port (``PARSERS``) giving the JAX parser's
output on the same bytes (the cores' snapshots, the per-rank trace
directory, the hung job's flight-recorder dumps); the CLIs of the port's
modules on those artifacts; the elastic driver's watch of rank 0's
``hvdtpu_dead_ranks``; the metrics-port preflight; and the SPMD timeline,
``torch.profiler``'s Chrome trace. This file is also the workers' script
(``HVDTPU_TEST_WORKER``).
"""

import base64
import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
JOB_DEADLINE = 150
JOBS_AT_ONCE = 2
SECRET = "0123456789abcdef0123456789abcdef"
# (kind, name, values): each rank's values come from numpy seed rank.
OPS = [("allreduce", f"grad/{i % 2}", 16384 if i % 2 == 0 else 256)
       for i in range(6)] + [("broadcast", "weights", 1024),
                             ("allgather", "stats", 8)]
PATHS = ("/metrics", "/healthz", "/debugz", "/perfz", "/gradz", "/profz")


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

def _free_base(n: int) -> int:
    """A port p with p..p+n all free on this host at the time of asking."""
    for _ in range(50):
        s = socket.socket()
        s.bind(("", 0))
        base = s.getsockname()[1]
        s.close()
        if base + n > 65535:
            continue
        held = []
        try:
            for p in range(base, base + n + 1):
                t = socket.socket()
                held.append(t)
                t.bind(("", p))
            return base
        except OSError:
            continue
        finally:
            for t in held:
                t.close()
    raise RuntimeError("no free run of ports")


def _launch(pkg: str, flags, worker: str, out, extra_env=None):
    from conftest import subprocess_env
    env = subprocess_env()
    env.update(HVDTPU_TEST_WORKER=worker, HVDTPU_TEST_OUT=str(out),
               HVDTPU_SECRET=SECRET, **(extra_env or {}))
    module = ("horovod_tpu_torch" if pkg == "port" else "horovod_tpu") + \
        ".runner.launch"
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "-np", "2", *flags, sys.executable,
         HERE], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        out = proc.communicate(timeout=JOB_DEADLINE)[0]
        return proc.returncode, out
    except subprocess.TimeoutExpired:
        # SIGTERM: the launcher stops its workers' process groups.
        proc.terminate()
        try:
            out = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        return "deadline", out


def _full_job(pkg: str, d):
    base = _free_base(2)
    flags = ["--metrics-port", str(base), "--metrics-interval", "0.5",
             "--debugz", "--top", "--top-once",
             "--trace", str(d / "trace"), "--trace-sample", "1",
             "--perf-profile", str(d / "perf"),
             "--grad-profile", str(d / "grad"),
             "--profile", str(d / "prof"), "--prof-clock", "wall",
             "--prof-hz", "499", "--postmortem", str(d / "pm"),
             "--compression", "int8", "--compression-min-bytes", "4096"]
    rc, out = _launch(pkg, flags, pkg, d, {"HVDTPU_TEST_BASE": str(base)})
    return {"rc": rc, "out": out, "dir": d, "base": base}


def _hang_job(d):
    rc, out = _launch("port", ["--postmortem", str(d / "pm"), "--chaos",
                               "rank1:hang@op=3"], "hang", d,
                      {"HVDTPU_READ_DEADLINE_SECONDS": "2",
                       "HVDTPU_FAILURE_DETECT_MS": "200"})
    return {"rc": rc, "out": out, "dir": d}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    run = {"port": lambda d: _full_job("port", d),
           "jax": lambda d: _full_job("jax", d), "hang": _hang_job}
    with concurrent.futures.ThreadPoolExecutor(JOBS_AT_ONCE) as pool:
        futures = {k: pool.submit(f, tmp_path_factory.mktemp(k))
                   for k, f in run.items()}
        return {k: f.result() for k, f in futures.items()}


def _ranks(job):
    out = []
    for r in range(2):
        with open(job["dir"] / f"{r}.json") as f:
            out.append(json.load(f))
    return out


def _snap(res, key) -> bytes:
    return base64.b64decode(res["snapshots"][key])


# ---------------------------------------------------------------------------
# the launcher, the endpoints and the live cores
# ---------------------------------------------------------------------------

def test_launcher_flags_end_to_end(jobs):
    job = jobs["port"]
    assert job["rc"] == 0, job["out"][-4000:]
    out, d, base = job["out"], job["dir"], job["base"]
    for r in range(2):
        assert f"rank {r} -> http://localhost:{base + r}/metrics" in out
        assert f"rank {r} -> http://localhost:{base + r}/debugz" in out
    assert f":{base + 2}/metrics (aggregated)" in out
    assert "2/2 ranks up" in out, out[-3000:]  # --top --top-once's frame
    assert "hvdrun: trace: merged 2 rank trace(s)" in out
    for name in ("trace/merged_trace.json", "perf/perf_profile.json",
                 "grad/grad_profile.json", "prof/profile_merged.folded",
                 "prof/profile.speedscope.json"):
        assert (d / name).stat().st_size > 0, name
    # A clean run leaves no verdict and no dump.
    assert "post-mortem verdict" not in out
    assert not list((d / "pm").glob("flightrec.*.bin"))


def test_endpoints_need_the_secret(jobs):
    for res in _ranks(jobs["port"]):
        assert res["served"] == {p: 200 for p in PATHS}, res["served"]
        assert res["refused"] == {p: 403 for p in PATHS}, res["refused"]
        assert json.loads(res["healthz"])["rank"] == res["rank"]


def test_hvdtop_cli_once(jobs):
    res = _ranks(jobs["port"])[0]
    rc, text = res["hvdtop"]
    assert rc == 0 and "2/2 ranks up" in text, text


def _families(text):
    from horovod_tpu_torch.observability import parse_prometheus_text
    return {name: (fam["type"],
                   sorted({tuple(sorted(lbls)) for _, lbls, _ in
                           fam["samples"]}))
            for name, fam in parse_prometheus_text(text).items()}


def test_live_metric_families_match_jax(jobs):
    assert jobs["jax"]["rc"] == 0, jobs["jax"]["out"][-4000:]
    from horovod_tpu_torch.observability import (parse_prometheus_text,
                                                 sample_value)
    for port, ref in zip(_ranks(jobs["port"]), _ranks(jobs["jax"])):
        assert _families(port["metrics"]) == _families(ref["metrics"])
        a, b = (parse_prometheus_text(x["metrics"]) for x in (port, ref))
        # The port's init runs one allgather more (the ranks' local sizes,
        # for is_homogeneous).
        for kind, extra in (("ALLREDUCE", 0), ("BROADCAST", 0),
                            ("ALLGATHER", 1)):
            got = sample_value(a, "hvdtpu_ops_total", op=kind)
            assert got and got == sample_value(b, "hvdtpu_ops_total",
                                               op=kind) + extra, kind


# ---------------------------------------------------------------------------
# the parsers, on the same bytes
# ---------------------------------------------------------------------------

def _mods(name):
    import importlib
    return (importlib.import_module(f"horovod_tpu_torch.{name}"),
            importlib.import_module(f"horovod_tpu.{name}"))


def _plain(x):
    """A parser's output with its classes replaced by their fields."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "to_dict"):
        return {"class": type(x).__name__, **_plain(x.to_dict())}
    if hasattr(x, "__dict__"):
        return {"class": type(x).__name__, **_plain(vars(x))}
    return x


def _case_prometheus(jobs, name):
    port, ref = _mods("observability")
    text = _ranks(jobs["port"])[0]["metrics"]
    if name == "parse_prometheus_text":
        return port.parse_prometheus_text(text), \
            ref.parse_prometheus_text(text)
    parsed = ref.parse_prometheus_text(text)
    if name == "render_exposition":
        return port.render_exposition(parsed), ref.render_exposition(parsed)
    got = [port.sample_value(parsed, "hvdtpu_ops_total", op="ALLREDUCE"),
           port.sample_value(parsed, "hvdtpu_cycles_total")]
    want = [ref.sample_value(parsed, "hvdtpu_ops_total", op="ALLREDUCE"),
            ref.sample_value(parsed, "hvdtpu_cycles_total")]
    assert got[0] is not None
    return got, want


def _case_flightrec(jobs, name):
    port, ref = _mods("flightrec")
    snap = _snap(_ranks(jobs["port"])[1], "flightrec")
    if name == "parse_dump":
        return _plain(port.parse_dump(snap)), _plain(ref.parse_dump(snap))
    return port.debugz_dict(snap, last_n=20), ref.debugz_dict(snap,
                                                              last_n=20)


def _case_snapshot(jobs, name):
    """perfstats and gradstats: parse_snapshot and format_report of both;
    find_straggler over the ranks' perf snapshots; worst_snr of each
    rank's grad snapshot."""
    ranks = _ranks(jobs["port"])
    out = ([], [])
    for module, kind in (("perfstats", "perf"), ("gradstats", "grad")):
        mods = _mods(module)
        snaps = [_snap(res, kind) for res in ranks]
        parsed = [mods[1].parse_snapshot(s) for s in snaps]
        for side, m in zip(out, mods):
            if name == "parse_snapshot":
                side.append([m.parse_snapshot(s) for s in snaps])
            elif name == "format_report":
                side.append([m.format_report(p) for p in parsed])
            elif name == "find_straggler" and kind == "perf":
                side.append(m.find_straggler(dict(enumerate(parsed))))
            elif name == "worst_snr" and kind == "grad":
                side.append([m.worst_snr(p) for p in parsed])
    if name == "worst_snr":
        assert all(w is not None for w in out[0][0]), out[0]
    return out


def _case_profiler(jobs, name):
    port, ref = _mods("profiler")
    doc = ref.parse_snapshot(_snap(_ranks(jobs["port"])[0], "prof"))
    assert doc["stacks"], doc
    return port.to_folded_text(doc), ref.to_folded_text(doc)


def _case_trace(jobs, name):
    port, ref = _mods("trace_analysis")
    trace_dir = str(jobs["port"]["dir"] / "trace")
    per_rank = ref.load_trace_dir(trace_dir)
    if name == "merge_events":
        return port.merge_events(per_rank), ref.merge_events(per_rank)
    got = port.build_report(trace_dir)
    assert got["critical_path"], got
    return got, ref.build_report(trace_dir)


def _case_postmortem(jobs, name):
    port, ref = _mods("postmortem")
    pm = str(jobs["hang"]["dir"] / "pm")
    return (_plain(m.build_verdict(f.load_dump_dir(pm)))
            for m, f in zip((port, ref), _mods("flightrec")))


def _case_agg(jobs, name):
    from horovod_tpu.observability import parse_prometheus_text
    from horovod_tpu.runner import metrics_agg as ref

    from horovod_tpu_torch.runner import metrics_agg as port
    texts = {r: res["metrics"] for r, res in enumerate(_ranks(jobs["port"]))}
    if name == "relabel_with_rank":
        return port.relabel_with_rank(texts[1], 1), \
            ref.relabel_with_rank(texts[1], 1)
    if name == "merge_dumps":
        return port.merge_dumps(texts), ref.merge_dumps(texts)
    parsed = {r: parse_prometheus_text(t) for r, t in texts.items()}
    hist = next(n for n, f in parsed[0].items() if f["type"] == "histogram"
                and any(s == "count" and v > 0 for s, _, v in f["samples"]))
    return ([m.histogram_quantile(parsed, hist, q) for q in (0.5, 0.99)]
            for m in (port, ref))


def _case_frame(jobs, name):
    from horovod_tpu.gradstats import parse_snapshot as grad
    from horovod_tpu.observability import parse_prometheus_text
    from horovod_tpu.perfstats import parse_snapshot as perf
    from horovod_tpu.runner import hvdtop as ref

    from horovod_tpu_torch.runner import hvdtop as port
    ranks = _ranks(jobs["port"])
    endpoints = {r: ("localhost", 9000 + r) for r in range(2)}
    args = (endpoints,
            {r: parse_prometheus_text(x["metrics"])
             for r, x in enumerate(ranks)},
            {r: perf(_snap(x, "perf")) for r, x in enumerate(ranks)},
            None, 100.0, {r: grad(_snap(x, "grad"))
                          for r, x in enumerate(ranks)})
    # The first line holds the wall-clock time of the call.
    return ((text.splitlines()[1:], _plain(prev))
            for text, prev in (port.render_frame(*args),
                               ref.render_frame(*args)))


PARSERS = {
    "parse_prometheus_text": _case_prometheus,
    "render_exposition": _case_prometheus,
    "sample_value": _case_prometheus,
    "parse_dump": _case_flightrec,
    "debugz_dict": _case_flightrec,
    "parse_snapshot": _case_snapshot,
    "format_report": _case_snapshot,
    "find_straggler": _case_snapshot,
    "worst_snr": _case_snapshot,
    "to_folded_text": _case_profiler,
    "merge_events": _case_trace,
    "build_report": _case_trace,
    "build_verdict": _case_postmortem,
    "relabel_with_rank": _case_agg,
    "merge_dumps": _case_agg,
    "histogram_quantile": _case_agg,
    "render_frame": _case_frame,
}


@pytest.mark.parametrize("name", list(PARSERS))
def test_parser_matches_jax(jobs, name):
    got, want = PARSERS[name](jobs, name)
    assert _plain(got) == _plain(want)


# ---------------------------------------------------------------------------
# the hung rank, the artifacts' CLIs
# ---------------------------------------------------------------------------

def test_postmortem_names_the_hung_rank(jobs):
    job = jobs["hang"]
    assert job["rc"] not in (0, "deadline"), job["out"][-4000:]
    assert "post-mortem verdict" in job["out"], job["out"][-4000:]
    from horovod_tpu_torch.flightrec import load_dump_dir
    from horovod_tpu_torch.postmortem import build_verdict
    verdict = build_verdict(load_dump_dir(str(job["dir"] / "pm")))
    convicted = [d["rank"] for d in verdict["dead"]]
    assert 1 in convicted and 0 not in convicted, verdict
    assert (job["dir"] / "pm" / "merged_postmortem.json").exists()


@pytest.mark.parametrize("module,args,rc", [
    ("trace_analysis", ["{d}/trace", "--require-critical-path",
                        "--no-merged"], 0),
    ("perfstats", ["{d}/perf", "{d}/perf"], 0),
    ("gradstats", ["{d}/grad", "{d}/grad"], 0),
    ("profiler", ["{d}/prof", "--require-samples", "--no-merged"], 0),
    ("postmortem", ["{h}/pm", "--json", "-o", "{h}/cli_merged.json"], 0),
    ("postmortem", ["{d}/pm"], 1)])
def test_module_clis(jobs, module, args, rc, capsys):
    """``python -m horovod_tpu_torch.<module>``'s ``main`` on the jobs'
    artifacts (in this process: the module's ``__main__`` calls it)."""
    import importlib
    d, h = jobs["port"]["dir"], jobs["hang"]["dir"]
    main = importlib.import_module(f"horovod_tpu_torch.{module}").main
    got = main([a.format(d=d, h=h) for a in args])
    out = capsys.readouterr()
    assert got == rc, out.out + out.err


# ---------------------------------------------------------------------------
# in-process: the driver's watch, the preflight, the SPMD timeline
# ---------------------------------------------------------------------------

def test_elastic_driver_watches_rank0_dead_ranks(monkeypatch):
    """``metrics_base`` no longer raises; the watch reads the current
    round's rank 0 once the round has formed, and starts a round, once,
    on a dead rank."""
    from horovod_tpu_torch.observability import MetricsServer
    from horovod_tpu_torch.runner import elastic

    server = MetricsServer(
        dump_fn=lambda: "# TYPE hvdtpu_dead_ranks gauge\n"
                        "hvdtpu_dead_ranks 1\n", port=0, secret=SECRET)
    server.start()
    driver = elastic.ElasticDriver(
        elastic.FixedHosts({"localhost": 2}),
        elastic.ElasticSettings(min_np=2, max_np=2,
                                hint_poll_interval_s=0.05),
        [sys.executable, "-c", "pass"], {"HVDTPU_SECRET": SECRET},
        metrics_base=server.port)
    rounds = []
    monkeypatch.setattr(driver, "_rendezvous", rounds.append)
    driver._controller_host, driver._epoch = "127.0.0.1", 1
    try:
        import threading
        t = threading.Thread(target=driver._metrics_monitor_loop,
                             daemon=True)
        t.start()
        time.sleep(1.2)  # not formed: rank 0 may still serve its last world
        assert rounds == []
        driver._formed_epoch = 1
        deadline = time.monotonic() + 20
        while not rounds and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(1.2)  # no second round for the same epoch
        assert rounds == ["dead rank reported by metrics"]
    finally:
        driver._shutdown.set()
        server.stop()


def test_metrics_port_preflight_names_busy_ports():
    from horovod_tpu_torch.runner.preflight import check_metrics_ports
    s = socket.socket()
    s.bind(("", 0))
    s.listen()
    busy = s.getsockname()[1]
    try:
        with pytest.raises(RuntimeError, match=f"rank 1: port {busy}"):
            check_metrics_ports(["localhost", "localhost"], busy - 1)
        with pytest.raises(RuntimeError, match="driver aggregator"):
            check_metrics_ports([], busy, aggregator_port=busy)
    finally:
        s.close()


def test_metrics_port_taken_fails_init_and_frees_the_core(monkeypatch):
    """A world of one in process mode whose metrics port is taken: init
    raises naming the port and the knob, and shuts its core down, so the
    same controller port forms a world at once after."""
    from conftest import free_port

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.exceptions import NotInitializedError
    busy = socket.socket()
    busy.bind(("", 0))
    busy.listen()
    for key, value in {"HVDTPU_RANK": "0", "HVDTPU_SIZE": "1",
                       "HVDTPU_CONTROLLER_PORT": str(free_port()),
                       "HVDTPU_METRICS_PORT":
                           str(busy.getsockname()[1])}.items():
        monkeypatch.setenv(key, value)
    try:
        with pytest.raises(NotInitializedError,
                           match=f"port {busy.getsockname()[1]} "
                                 r"\(HVDTPU_METRICS_PORT="):
            hvd.init(mode="process", device="cpu")
        assert not hvd.is_initialized()
        monkeypatch.delenv("HVDTPU_METRICS_PORT")
        hvd.init(mode="process", device="cpu")
        assert hvd.metrics_server() is None and hvd.metrics()
    finally:
        hvd.shutdown()
        busy.close()


def test_spmd_timeline_writes_a_chrome_trace(tmp_path):
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        hvd.start_timeline(str(tmp_path / "tl"))
        hvd.allreduce(torch.ones(64), name="timeline.t")
        path = hvd.stop_timeline()
        assert hvd.stop_timeline() is None  # none runs any more
    finally:
        hvd.shutdown()
    assert path == str(tmp_path / "tl") + ".0.pt.trace.json"
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("all_reduce" in n or "allreduce" in n for n in names), names


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _scrape(port: int, path: str, secret):
    from horovod_tpu_torch.observability import scrape
    try:
        return 200, scrape("127.0.0.1", port, path=path, secret=secret,
                           timeout=10.0)
    except urllib.error.HTTPError as exc:
        return exc.code, ""


def _worker(kind: str) -> None:
    out = os.environ["HVDTPU_TEST_OUT"]
    if kind == "jax":
        import horovod_tpu as hvd
        hvd.init()
        core = hvd.runtime.core()

        def tensor(x):
            return x
    else:
        import torch

        import horovod_tpu_torch as hvd
        hvd.init(mode="process", device="cpu")
        core = hvd.runtime.core()
        tensor = torch.from_numpy
    r = hvd.rank()
    rng = np.random.RandomState(r)
    for i, (op, name, n) in enumerate(OPS):
        x = tensor(rng.randn(n).astype(np.float32))
        if kind == "hang" and i >= 3:
            x = tensor(np.ones(n, np.float32))
        if op == "allreduce":
            hvd.allreduce(x, op=hvd.Sum, name=name)
        elif op == "broadcast":
            hvd.broadcast(x, 0, name=name)
        else:
            hvd.allgather(x, name=name)
    if kind == "hang":
        hvd.shutdown()
        return
    base = int(os.environ["HVDTPU_TEST_BASE"]) + r
    res = {"rank": r, "metrics": hvd.metrics_dump(),
           "served": {}, "refused": {}, "snapshots": {
               key: base64.b64encode(fn()).decode() for key, fn in (
                   ("flightrec", core.flightrec_snapshot),
                   ("perf", core.perfstats_snapshot),
                   ("grad", core.gradstats_snapshot),
                   ("prof", core.profiler_snapshot))}}
    for path in PATHS:
        res["served"][path], body = _scrape(base, path, SECRET)
        res["refused"][path] = _scrape(base, path, None)[0]
        if path == "/healthz":
            res["healthz"] = body
    if kind == "port" and r == 0:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.hvdtop",
             "--port", str(base), "-np", "2", "--once", "--once-timeout",
             "30"], capture_output=True, text=True, timeout=60)
        res["hvdtop"] = (proc.returncode, proc.stdout + proc.stderr)
    with open(os.path.join(out, f"{r}.json"), "w") as f:
        json.dump(res, f)
    # Both ranks are past their scrapes; the JAX core needs the join before
    # its shutdown (ROADMAP C7), the port's does not.
    hvd.allreduce(tensor(np.ones(1, np.float32)), name="done")
    if kind == "jax":
        hvd.join()
    hvd.shutdown()


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    _worker(os.environ["HVDTPU_TEST_WORKER"])
