"""The port's launcher (``horovod_tpu_torch.runner``) against the JAX
package's (``horovod_tpu.runner``), then on its own.

Against the JAX package, on the same inputs: the host tables
(``get_host_assignments`` with uneven slots, ``-np`` below the slot
count and repeated hosts; ``parse_hosts``, ``parse_hostfile``,
``host_groups``; the errors' classes), ``launch.parse_args`` (``vars()``
equal for static, elastic, tuning and ``--config-file`` command lines),
``_build_env`` and ``_apply_tuning_env`` (equal dicts for the same slot,
flags and secret), ``safe_exec.ssh_wrap``/``resolve_python`` (equal
argv), ``http_kv._sign`` (equal bytes) and the key-value store both ways:
a port server with a JAX client and a JAX server with a port client,
PUT, GET and DELETE, and a wrong secret refused with 403.

The port alone: a static launch of a process-mode world of 2 on the CPU
(an allreduce, exit 0), a failing rank's exit code, ``hvd.run(fn, np=2)``,
the connectivity preflight's probes, ``--check-build``, and the
observability flags refused where the JAX launcher refuses them, with its
message, and otherwise giving the workers its environment.

This file is also the workers' script: run with ``HVDTPU_TEST_WORKER``
set, it runs one rank (imports no JAX).
"""

import dataclasses
import io
import os
import subprocess
import sys
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import pytest

from horovod_tpu_torch.runner import hosts as thosts
from horovod_tpu_torch.runner import http_kv as tkv
from horovod_tpu_torch.runner import launch as tlaunch
from horovod_tpu_torch.runner import safe_exec as tsafe

SECRET = "0123456789abcdef0123456789abcdef"
JOB_TIMEOUT = 120


# ---------------------------------------------------------------------------
# hosts
# ---------------------------------------------------------------------------

HOST_TABLE = [
    ("localhost:4", 4),
    ("localhost:4", 2),
    ("a:2,b:4,c:1", 7),
    ("a:2,b:4,c:1", 5),
    ("a:3,b:1,c:3", 7),
    ("a:1,a:1,b:2", 4),
    ("h1,h2,h3", 3),
    ("a:4,b:4", 1),
    ("a:2,b:2", 5),
    ("", 1),
]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as exc:  # the class is compared
        return type(exc)


@pytest.mark.parametrize("hosts_str,np_", HOST_TABLE)
def test_host_assignments_match(hosts_str, np_):
    from horovod_tpu.runner import hosts as jhosts
    parsed = thosts.parse_hosts(hosts_str)
    assert parsed == jhosts.parse_hosts(hosts_str)
    got = _outcome(thosts.get_host_assignments, parsed, np_)
    want = _outcome(jhosts.get_host_assignments, parsed, np_)
    if isinstance(want, type):
        assert got is want is ValueError
        return
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert dict(thosts.host_groups(got)) == dict(jhosts.host_groups(want))


def test_hostfile_matches(tmp_path):
    from horovod_tpu.runner import hosts as jhosts
    path = tmp_path / "hostfile"
    path.write_text("# a cluster\nnode1 slots=4\n\nnode2\n"
                    "node3 slots=2 max_slots=8  # trailing\n")
    assert thosts.parse_hostfile(str(path)) == \
        jhosts.parse_hostfile(str(path)) == \
        [("node1", 4), ("node2", 1), ("node3", 2)]
    bad = tmp_path / "bad"
    bad.write_text("node1 slots=x\n")
    for parse in (thosts.parse_hostfile, jhosts.parse_hostfile):
        with pytest.raises(ValueError):
            parse(str(bad))


# ---------------------------------------------------------------------------
# parse_args, _build_env, _apply_tuning_env
# ---------------------------------------------------------------------------

ARGVS = {
    "static": ["-np", "4", "python", "train.py", "--lr", "0.1"],
    "hosts": ["-np", "8", "-H", "h1:4,h2:4", "--ssh-port", "2222",
              "--remote-python", "python3.12", "--no-preflight",
              "--controller-advertise-address", "10.0.0.1", "-p", "12345",
              "python", "train.py"],
    "dashdash": ["-np", "2", "--", "python", "-m", "mod"],
    "elastic": ["-np", "2", "--min-np", "2", "--max-np", "4",
                "--host-discovery-script", "./discover.sh", "--slots", "2",
                "--elastic-timeout", "30", "--reset-limit", "3",
                "python", "train.py"],
    "tuning": ["-np", "2", "--fusion-threshold-mb", "32",
               "--cycle-time-ms", "2.5", "--allreduce-algo", "ring",
               "--sa-group", "8", "--no-ctrl-batch", "--bcast-flat-max",
               "1024", "--hier", "--no-shm", "--shm-ring-bytes", "65536",
               "--tcp-zerocopy", "off", "--shm-numa", "on",
               "--doorbell-batch", "4096", "--compression", "int4",
               "--compression-min-bytes", "2048", "--timeline", "/tmp/tl",
               "--timeline-mark-cycles", "--trace-sample", "3",
               "--prof-hz", "50", "--prof-clock", "wall",
               "--perf-slowdown-pct", "25", "--no-perfstats",
               "--nancheck", "abort", "--gradcheck-sample", "16",
               "--no-gradstats", "--metrics-interval", "5",
               "--stall-check-disable",
               "--stall-check-warning-time-seconds", "30",
               "--stall-check-shutdown-time-seconds", "300",
               "--cache-capacity", "0", "--autotune",
               "--autotune-log-file", "/tmp/at.csv",
               "--autotune-warmup-samples", "2",
               "--autotune-steps-per-sample", "5",
               "--autotune-bayes-opt-max-samples", "9",
               "--autotune-gaussian-process-noise", "0.5",
               "python", "train.py"],
    "no_hier": ["-np", "3", "--no-hier", "--verbose", "python", "t.py"],
    "config": ["--config-file", "{config}", "-np", "2", "--cycle-time-ms",
               "7", "python", "train.py"],
}

CONFIG = """\
fusion-threshold-mb: 16
cycle-time-ms: 3.0
allreduce_algo: tree
no-shm: true
min-np: 2
"""


def _argv(name, tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(CONFIG)
    return [a.format(config=path) for a in ARGVS[name]]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_args_matches(name, tmp_path):
    from horovod_tpu.runner import launch as jlaunch
    argv = _argv(name, tmp_path)
    got, want = vars(tlaunch.parse_args(argv)), vars(jlaunch.parse_args(argv))
    # 65 options with -h (64 in vars()) and the command.
    assert len(got) == len(want) == 65
    assert got == want
    if name == "config":
        # The file beats the defaults, the command line beats the file.
        assert (got["fusion_threshold_mb"], got["cycle_time_ms"],
                got["allreduce_algo"], got["no_shm"]) == (16, 7.0, "tree",
                                                          True)


@pytest.mark.parametrize("name", ["static", "hosts", "tuning", "no_hier",
                                  "config"])
def test_worker_env_matches(name, tmp_path, monkeypatch):
    from horovod_tpu.runner import hosts as jhosts
    from horovod_tpu.runner import launch as jlaunch
    monkeypatch.setenv("HVDTPU_SECRET", SECRET)
    monkeypatch.delenv("HVDTPU_ALLREDUCE_HIER", raising=False)
    argv = _argv(name, tmp_path)
    targs, jargs = tlaunch.parse_args(argv), jlaunch.parse_args(argv)
    for slot_t, slot_j in zip(
            thosts.get_host_assignments([("h1", 2), ("h2", 3)], 4),
            jhosts.get_host_assignments([("h1", 2), ("h2", 3)], 4)):
        got = tlaunch._build_env(slot_t, targs, "h1", 23456)
        want = jlaunch._build_env(slot_j, jargs, "h1", 23456)
        assert got == want
    assert tlaunch._apply_tuning_env({"HVDTPU_ALLREDUCE_HIER": "1"},
                                     targs) == \
        jlaunch._apply_tuning_env({"HVDTPU_ALLREDUCE_HIER": "1"}, jargs)


def test_tuning_errors_match(monkeypatch):
    from horovod_tpu.runner import launch as jlaunch
    monkeypatch.setenv("HVDTPU_SECRET", SECRET)
    for argv in (["--hier", "--no-hier"], ["--sa-group", "-1"],
                 ["--prof-hz", "0"], ["--doorbell-batch", "-2"]):
        argv = ["-np", "1"] + argv + ["true"]
        msgs = []
        for launch in (tlaunch, jlaunch):
            with pytest.raises(SystemExit) as exc:
                launch._apply_tuning_env({}, launch.parse_args(argv))
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1], argv


# ---------------------------------------------------------------------------
# safe_exec and the key-value store
# ---------------------------------------------------------------------------

def test_ssh_wrap_and_resolve_python_match():
    from horovod_tpu.runner import safe_exec as jsafe
    env = {"HVDTPU_RANK": "3", "HVDTPU_SECRET": SECRET, "PATH": "/bin",
           "HVDTPU_HOSTNAME": "h2", "HVDTPU_TIMELINE": "/tmp/a b.json"}
    cmd = ["{python}", "-m", "train", "--x", "1"]
    for local in (True, False):
        assert tsafe.resolve_python(cmd, local, "python3.12") == \
            jsafe.resolve_python(cmd, local, "python3.12")
    assert tsafe.resolve_python(["python", "t.py"], False) == \
        jsafe.resolve_python(["python", "t.py"], False)
    assert tsafe.ssh_wrap("h2", 2222, env, ["python", "t.py"]) == \
        jsafe.ssh_wrap("h2", 2222, env, ["python", "t.py"])
    env.pop("HVDTPU_SECRET")
    assert tsafe.ssh_wrap("h2", 22, env, ["python", "t.py"]) == \
        jsafe.ssh_wrap("h2", 22, env, ["python", "t.py"])


@pytest.mark.parametrize("body", [b"", b"x", bytes(range(256))])
def test_sign_matches(body):
    from horovod_tpu.runner import http_kv as jkv
    for method in ("GET", "PUT", "DELETE"):
        assert tkv._sign(SECRET, method, "/rendezvous/1/a", body) == \
            jkv._sign(SECRET, method, "/rendezvous/1/a", body)


def _delete(port, key, secret, sign):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{key}",
                                 method="DELETE",
                                 headers={tkv._AUTH_HEADER: sign(
                                     secret, "DELETE", key, b"")})
    urllib.request.urlopen(req, timeout=10).read()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_kv_store_across_packages(server_pkg):
    """A server of one package, a client of the other: PUT, GET, DELETE,
    and 403 for a wrong secret."""
    from horovod_tpu.runner import http_kv as jkv
    server_mod, client_mod = (tkv, jkv) if server_pkg == "port" else \
        (jkv, tkv)
    server = server_mod.KVStoreServer(secret=SECRET)
    server.start()
    try:
        client = client_mod.KVStoreClient("127.0.0.1", server.port,
                                          secret=SECRET)
        payload = bytes(range(256)) * 3
        client.put("/rendezvous/2/assignment/h:0", payload)
        assert client.get("/rendezvous/2/assignment/h:0") == payload
        assert server.get("/rendezvous/2/assignment/h:0") == payload
        assert client.get("/absent") is None
        server.put("/rendezvous/epoch", b"7")
        assert client.get("/rendezvous/epoch") == b"7"
        assert sorted(server.keys("/rendezvous/")) == [
            "/rendezvous/2/assignment/h:0", "/rendezvous/epoch"]
        # DELETE (neither client sends one), signed by the client
        # package's _sign.
        _delete(server.port, "/rendezvous/epoch", SECRET, client_mod._sign)
        assert client.get("/rendezvous/epoch") is None
        wrong = client_mod.KVStoreClient("127.0.0.1", server.port,
                                         secret="not-the-secret")
        for call in (lambda: wrong.get("/rendezvous/2/assignment/h:0"),
                     lambda: wrong.put("/x", b"1")):
            with pytest.raises(urllib.error.HTTPError) as exc:
                call()
            assert exc.value.code == 403
        unsigned = client_mod.KVStoreClient("127.0.0.1", server.port)
        with pytest.raises(urllib.error.HTTPError) as exc:
            unsigned.get("/rendezvous/2/assignment/h:0")
        assert exc.value.code == 403
        assert server.get("/x") is None
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _launch(argv, extra_env=None):
    """``python -m horovod_tpu_torch.runner.launch argv`` with this file
    as the workers' script; (exit code, stdout, stderr)."""
    from conftest import subprocess_env
    env = subprocess_env()
    env.update(extra_env or {})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv],
        env=env, capture_output=True, text=True, timeout=JOB_TIMEOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc.returncode, proc.stdout, proc.stderr


def test_static_launch_process_world(tmp_path):
    """Two ranks of a process-mode world on the CPU: the launcher's
    topology variables reach them, their allreduce is exact, exit 0."""
    rc, out, err = _launch(
        ["-np", "2", "-H", "localhost:2", "--cycle-time-ms", "2",
         sys.executable, os.path.abspath(__file__)],
        {"HVDTPU_TEST_WORKER": "allreduce",
         "HVDTPU_TEST_OUT": str(tmp_path)})
    assert rc == 0, err + out
    lines = sorted((tmp_path / f"{r}.txt").read_text() for r in range(2))
    assert lines == [
        "rank=0 size=2 local=0/2 cross=0/1 host=localhost cycle=2.0 "
        "sum=[3.0, 3.0, 3.0]",
        "rank=1 size=2 local=1/2 cross=0/1 host=localhost cycle=2.0 "
        "sum=[3.0, 3.0, 3.0]"]


def test_failing_rank_exit_code(tmp_path):
    """A rank that exits 3 ends the job with 3 and stops its peer, which
    waits in its form-up for it."""
    rc, out, err = _launch(
        ["-np", "2", sys.executable, os.path.abspath(__file__)],
        {"HVDTPU_TEST_WORKER": "fail", "HVDTPU_TEST_OUT": str(tmp_path)})
    assert rc == 3, err + out
    assert "exited with code 3" in err


def test_run_returns_each_rank_result():
    import horovod_tpu_torch as thvd
    got = thvd.run(lambda base: base + 10 * __import__(
        "horovod_tpu_torch").rank() + __import__(
        "horovod_tpu_torch").size(), args=(5,), np=2, device="cpu")
    assert got == [7, 17]


def _probe_spawner():
    from conftest import subprocess_env

    def spawn(host, env):
        return tsafe.WorkerProcess(
            [sys.executable, "-m", "horovod_tpu_torch.runner.preflight"],
            {**subprocess_env(), **env}, f"preflight@{host}")
    return spawn


def test_preflight_probes_every_host():
    """The connectivity preflight with its probe entry: ``localhost``
    listens on the controller's port and ``127.0.0.1`` reaches it; with
    the port taken, the listening host fails, naming it and the port."""
    import socket

    from horovod_tpu_torch.runner.launch import _free_port
    from horovod_tpu_torch.runner.preflight import check_connectivity
    port = _free_port()
    check_connectivity(["localhost", "127.0.0.1"], "127.0.0.1", port,
                       _probe_spawner(), timeout=30, secret=SECRET,
                       listen_host="localhost")
    with socket.socket() as taken:
        taken.bind(("", port))
        taken.listen(1)
        with pytest.raises(RuntimeError,
                           match=f"localhost: bind-failed on port {port}"):
            check_connectivity(["localhost"], "localhost", port,
                               _probe_spawner(), timeout=30, secret=SECRET)


def test_check_build_names_torch_and_core():
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        tlaunch.parse_args(["--check-build"])
    assert exc.value.code == 0
    text = buf.getvalue()
    assert "PyTorch" in text and "native core, process mode" in text
    assert "CUDA kernels, sm_90a" in text and "gloo" in text


@pytest.mark.parametrize("flags", [
    ["--metrics-port", "9000"], ["--top"], ["--debugz"],
    ["--trace", "{tmp}/trace"], ["--perf-profile", "{tmp}/perf"],
    ["--grad-profile", "{tmp}/grad"], ["--profile", "{tmp}/prof"],
    ["--postmortem", "{tmp}/pm"], ["env"]])
@pytest.mark.parametrize("elastic", [False, True])
def test_observability_flags_refused(flags, elastic, tmp_path, monkeypatch):
    """The observability flags (and a ``HVDTPU_METRICS_PORT`` the user
    exported) are refused exactly where the JAX launcher refuses them,
    with its message: ``--top`` and ``--debugz`` without a metrics port,
    ``--top`` in an elastic job; nothing starts. Every other case gives
    the workers the JAX launcher's environment, and makes the same
    artifact directory."""
    from horovod_tpu.runner import launch as jlaunch
    monkeypatch.delenv("HVDTPU_METRICS_PORT", raising=False)
    monkeypatch.setenv("HVDTPU_SECRET", SECRET)
    if flags == ["env"]:
        monkeypatch.setenv("HVDTPU_METRICS_PORT", "9100")
        flags = []
    extra = ["--host-discovery-script", str(tmp_path / "absent.sh")] \
        if elastic else []
    outs = {}
    for pkg, launch in (("port", tlaunch), ("jax", jlaunch)):
        sub = tmp_path / pkg
        argv = ["-np", "1", *extra,
                *[f.format(tmp=sub) for f in flags], "false"]
        args = launch.parse_args(argv)
        if flags in (["--top"], ["--debugz"]):
            with pytest.raises(SystemExit) as exc:
                launch.run_launcher(args)
            outs[pkg] = str(exc.value)
            assert not sub.exists()
            continue
        env = launch._apply_tuning_env({}, args)
        made = sorted(p.relative_to(sub).as_posix()
                      for p in sub.rglob("*")) if sub.exists() else []
        outs[pkg] = ({k: v.replace(str(sub), "DIR") for k, v in env.items()},
                     made)
    assert outs["port"] == outs["jax"], outs
    if flags == ["--metrics-port", "9000"]:
        assert outs["port"][0]["HVDTPU_METRICS_PORT"] == "9000"
    elif flags in (["--top"], ["--debugz"]):
        assert flags[0] in outs["port"], outs


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _worker(kind: str, out: str) -> None:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import envvars as ev
    if kind == "fail" and ev.get_int(ev.HVDTPU_RANK, 0) == 1:
        os._exit(3)  # rank 0 waits in its form-up until the launcher stops it
    hvd.init(mode="process", device="cpu")
    r = hvd.rank()
    total = hvd.allreduce(torch.full((3,), float(r + 1)), op=hvd.Sum,
                          name="runner.sum")
    with open(os.path.join(out, f"{r}.txt"), "w") as f:
        f.write(f"rank={r} size={hvd.size()} "
                f"local={hvd.local_rank()}/{hvd.local_size()} "
                f"cross={hvd.cross_rank()}/{hvd.cross_size()} "
                f"host={ev.get_str(ev.HVDTPU_HOSTNAME)} "
                f"cycle={ev.get_str(ev.HVDTPU_CYCLE_TIME)} "
                f"sum={total.tolist()}")
    hvd.join()  # no rank's core stops while a peer still reads from it
    hvd.shutdown()


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    _worker(os.environ["HVDTPU_TEST_WORKER"], os.environ["HVDTPU_TEST_OUT"])
