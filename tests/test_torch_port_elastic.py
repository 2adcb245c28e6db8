"""The port's elastic stack (``horovod_tpu_torch.runner.elastic`` and
``horovod_tpu_torch.elastic``) against the JAX package's, on the CPU.

* Discovery and registration: ``HostManager`` over ``FixedHosts``,
  ``HostDiscoveryScript`` (and its failure) and ``WorkerStateRegistry``
  give the same sequences in both packages: the cases of
  ``tests/test_elastic.py::TestDiscovery``, one parametrised test over
  both.
* The JAX integration scenarios of ``tests/test_elastic.py`` with port
  workers (an ``ObjectState`` counter in process mode on the CPU) reach
  the outcomes those tests assert: a static world, a failure that
  blacklists its host, scale up, scale down, a rendezvous that times out
  and the reset limit.
* Failure recovery with ``TorchState``: a small MLP through
  ``DistributedOptimizer`` (SGD with momentum), three workers
  (``localhost:2`` and ``127.0.0.1:1``), the worker of ``127.0.0.1`` dies
  before its step of batch 3, the survivors restore their commit and
  finish 8 batches as a world of 2. The same schedule runs once with the
  port's workers and once with ``horovod_tpu.torch``'s (its
  ``TorchState``), both under the port's driver, which speaks the JAX
  driver's wire; the finishers' weights agree within rtol 1e-4, atol 1e-5
  (``test_torch_port_process.py::test_training_matches_the_references``'
  tolerance), and each survivor's weights after every restore and sync
  are bitwise those it committed at that batch (batch 3 among them).

Every job runs in a thread of the module's fixture, two at a time, each
with its own deadline (``JOB_DEADLINE``); a job past it is stopped, its
workers' process groups killed, and its test fails. This file is also the
workers' script (``HVDTPU_TEST_WORKER``).
"""

import concurrent.futures
import hashlib
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest

JOB_DEADLINE = 240.0
# Jobs run two at a time: at most about five workers start at once,
# beside the other test files' processes.
JOBS_AT_ONCE = 2
HERE = os.path.abspath(__file__)
MLP_BATCHES, MLP_CRASH_AT, MLP_LR = 8, 3, 0.1


# ---------------------------------------------------------------------------
# discovery and registration, both packages
# ---------------------------------------------------------------------------

def _elastic(pkg):
    if pkg == "port":
        from horovod_tpu_torch.runner import elastic
    else:
        from horovod_tpu.runner import elastic
    return elastic


def _registration(pkg):
    if pkg == "port":
        from horovod_tpu_torch.runner.elastic import registration
    else:
        from horovod_tpu.runner.elastic import registration
    return registration


def _case_fixed_hosts_and_manager(pkg, tmp_path):
    e = _elastic(pkg)
    fh = e.FixedHosts({"a": 2, "b": 2})
    mgr = e.HostManager(fh)
    seq = [mgr.update_available_hosts(), mgr.current_hosts,
           mgr.update_available_hosts()]
    mgr.blacklist("a")
    seq += [mgr.is_blacklisted("a"), mgr.update_available_hosts(),
            mgr.current_hosts]
    fh.set({"a": 2, "b": 2, "c": 1, "d": 0})
    seq += [mgr.update_available_hosts(), mgr.current_hosts]
    assert seq[:3] == [True, {"a": 2, "b": 2}, False]
    assert seq[-1] == {"b": 2, "c": 1}  # the blacklist sticks
    return seq


def _case_discovery_script(pkg, tmp_path):
    script = tmp_path / f"discover_{pkg}.sh"
    script.write_text("#!/bin/sh\necho host1:4\necho host2\necho\n"
                      "echo host3:0\n")
    script.chmod(0o755)
    found = _elastic(pkg).HostDiscoveryScript(
        str(script), slots=2).find_available_hosts_and_slots()
    assert found == {"host1": 4, "host2": 2, "host3": 0}
    return found


def _case_discovery_script_failure(pkg, tmp_path):
    script = tmp_path / f"bad_{pkg}.sh"
    script.write_text("#!/bin/sh\necho oops >&2\nexit 3\n")
    script.chmod(0o755)
    with pytest.raises(RuntimeError) as exc:
        _elastic(pkg).HostDiscoveryScript(
            str(script)).find_available_hosts_and_slots()
    return str(exc.value)


def _case_registry(pkg, tmp_path):
    reg = _registration(pkg)
    r = _elastic(pkg).WorkerStateRegistry()
    r.record(1, "a:0", reg.SUCCESS)
    r.record(1, "a:1", reg.FAILURE)
    r.record(2, "a:0", reg.SUCCESS)
    r.record(2, "b:0", reg.SUCCESS)
    return [r.state_of(1, "a:1"), r.state_of(3, "a:0"),
            r.count(1, reg.SUCCESS), r.count(2, reg.SUCCESS),
            r.failures(1), r.failures(2),
            r.all_succeeded(1, {"a:0", "a:1"}),
            r.all_succeeded(2, {"a:0", "b:0"}), r.all_succeeded(2, set())]


DISCOVERY_CASES = {
    "fixed_hosts_and_manager": _case_fixed_hosts_and_manager,
    "discovery_script": _case_discovery_script,
    "discovery_script_failure": _case_discovery_script_failure,
    "registry": _case_registry,
}


@pytest.mark.parametrize("case", sorted(DISCOVERY_CASES))
def test_discovery_matches_jax(case, tmp_path):
    fn = DISCOVERY_CASES[case]
    assert fn("port", tmp_path) == fn("jax", tmp_path)


def test_chaos_marker_claimed_once_through_the_store(monkeypatch, tmp_path):
    """The one-shot chaos marker of an elastic job is claimed in the
    driver's store: the port's claim first, then the JAX package's sees
    it taken (one wire); without a store the file marker decides."""
    from horovod_tpu import chaos as jchaos
    from horovod_tpu_torch import chaos as tchaos
    from horovod_tpu_torch.runner.http_kv import KVStoreServer
    monkeypatch.delenv("HVDTPU_RENDEZVOUS_ADDR", raising=False)
    assert tchaos._claim_marker_kv(str(tmp_path / "m"), 0) is None
    server = KVStoreServer(secret="s3cret")
    server.start()
    try:
        monkeypatch.setenv("HVDTPU_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HVDTPU_RENDEZVOUS_PORT", str(server.port))
        monkeypatch.setenv("HVDTPU_SECRET", "s3cret")
        monkeypatch.setenv("HVDTPU_CHAOS", "rank1:kill@op=3")
        monkeypatch.setenv("HVDTPU_CHAOS_MARKER", str(tmp_path / "m"))
        assert tchaos.armed_chaos(1) == tchaos.ChaosSpec(action=1,
                                                         op_index=3)
        assert tchaos.armed_chaos(1) is None
        assert jchaos._claim_marker_kv(str(tmp_path / "m"), 1) is False
        assert server.get("/chaos/marker/m").startswith(b"armed rank=1")
        assert not (tmp_path / "m").exists()
    finally:
        server.stop()


def test_spmd_refused_under_the_driver(monkeypatch):
    """An elastic worker runs in process mode: ``mode="spmd"`` raises,
    naming it, before anything starts."""
    import horovod_tpu_torch as thvd
    monkeypatch.setenv("HVDTPU_RENDEZVOUS_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="process mode"):
        thvd.init(mode="spmd", device="cpu")
    assert not thvd.is_initialized()


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

def _discovery(tmp_path, content: str):
    hosts_file = tmp_path / "hosts.txt"
    hosts_file.write_text(content)
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    script.chmod(0o755)
    return str(script), hosts_file


def _env(tmp_path, worker: str, **extra):
    from conftest import subprocess_env
    env = subprocess_env()
    env.update(HVDTPU_TEST_WORKER=worker,
               ELASTIC_RESULT_FILE=str(tmp_path / "results.txt"),
               HVDTPU_STALL_CHECK_DISABLE="1", **extra)
    return env


def _results(tmp_path):
    path = tmp_path / "results.txt"
    return path.read_text().splitlines() if path.exists() else []


def _run_driver(script, settings, env, during=None):
    """Run one elastic job under the port's driver to its end or to
    ``JOB_DEADLINE``; its exit code, or the exception the driver raised.
    ``during(stop)`` runs in a thread beside it (the scenario's changes of
    hosts) until the job ends."""
    e = _elastic("port")
    driver = e.ElasticDriver(e.HostDiscoveryScript(script), settings,
                             [sys.executable, HERE], env)
    stop = threading.Event()
    side = threading.Thread(target=during, args=(stop,), daemon=True) \
        if during else None
    if side:
        side.start()
    try:
        driver.start()
        return driver.wait_for_completion(timeout=JOB_DEADLINE)
    except (TimeoutError, RuntimeError) as exc:
        return exc
    finally:
        driver.close()
        stop.set()
        if side:
            side.join()


def _job_static(tmp_path):
    script, _ = _discovery(tmp_path, "localhost:2\n")
    from horovod_tpu_torch.runner.elastic import ElasticSettings
    return _run_driver(script, ElasticSettings(
        min_np=2, max_np=2, discovery_interval_s=0.3, elastic_timeout_s=60),
        _env(tmp_path, "counter", ELASTIC_TARGET_BATCHES="6"))


def _job_scale_up(tmp_path):
    script, hosts_file = _discovery(tmp_path, "localhost:2\n")
    from horovod_tpu_torch.runner.elastic import ElasticSettings

    def grow(stop):
        if not stop.wait(4):
            hosts_file.write_text("localhost:3\n")
    return _run_driver(script, ElasticSettings(
        min_np=2, max_np=3, discovery_interval_s=0.3, elastic_timeout_s=60),
        _env(tmp_path, "counter", ELASTIC_TARGET_BATCHES="40",
             ELASTIC_BATCH_SLEEP="0.2"), grow)


def _job_failure(tmp_path):
    script, _ = _discovery(tmp_path, "localhost:2\n127.0.0.1:2\n")
    from horovod_tpu_torch.runner.elastic import ElasticSettings
    return _run_driver(script, ElasticSettings(
        min_np=2, max_np=2, discovery_interval_s=0.3, elastic_timeout_s=120),
        _env(tmp_path, "counter", ELASTIC_TARGET_BATCHES="30",
             ELASTIC_CRASH_AT="127.0.0.1:1:5",
             ELASTIC_CRASH_MARKER=str(tmp_path / "crashed.marker")))


def _job_scale_down(tmp_path):
    script, hosts_file = _discovery(tmp_path, "localhost:3\n")
    from horovod_tpu_torch.runner.elastic import ElasticSettings

    def shrink(stop):
        if not stop.wait(4):
            hosts_file.write_text("localhost:2\n")
    return _run_driver(script, ElasticSettings(
        min_np=2, max_np=3, discovery_interval_s=0.3, elastic_timeout_s=60),
        _env(tmp_path, "counter", ELASTIC_TARGET_BATCHES="40",
             ELASTIC_BATCH_SLEEP="0.2"), shrink)


def _job_rendezvous_timeout(tmp_path):
    script, _ = _discovery(tmp_path, "localhost:1\n")
    from horovod_tpu_torch.runner.elastic import ElasticSettings
    t0 = time.time()
    out = _run_driver(script, ElasticSettings(
        min_np=3, max_np=3, discovery_interval_s=0.2, elastic_timeout_s=3),
        _env(tmp_path, "counter", ELASTIC_TARGET_BATCHES="4"))
    return out, time.time() - t0


def _job_reset_limit(tmp_path):
    script, hosts_file = _discovery(tmp_path, "localhost:2\n")
    from horovod_tpu_torch.runner.elastic import ElasticSettings

    def churn(stop):
        n = 2
        while not stop.wait(1.0):
            n = 3 if n == 2 else 2
            hosts_file.write_text(f"localhost:{n}\n")
    return _run_driver(script, ElasticSettings(
        min_np=1, max_np=3, discovery_interval_s=0.2, elastic_timeout_s=30,
        reset_limit=2), _env(tmp_path, "counter",
                             ELASTIC_TARGET_BATCHES="10000"), churn)


def _job_torch(pkg, tmp_path):
    """The MLP job with ``pkg``'s workers, under the port's driver: it
    speaks the JAX driver's wire, and the JAX driver's own races (ROADMAP
    C5, C6) failed the JAX leg under load (its workers then saw rounds
    that the failure does not explain). ``tests/test_elastic.py`` covers
    the JAX driver."""
    script, _ = _discovery(tmp_path, "localhost:2\n127.0.0.1:1\n")
    settings = _elastic("port").ElasticSettings(
        min_np=2, max_np=3, discovery_interval_s=0.3, elastic_timeout_s=120)
    return _run_driver(script, settings, _env(
        tmp_path, f"torch_{pkg}", ELASTIC_OUT=str(tmp_path)))


# The longest first.
JOBS = {"torch_jax": lambda d: _job_torch("jax", d),
        "failure": _job_failure, "scale_up": _job_scale_up,
        "scale_down": _job_scale_down,
        "torch_port": lambda d: _job_torch("port", d),
        "reset_limit": _job_reset_limit, "static": _job_static,
        "rendezvous_timeout": _job_rendezvous_timeout}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job, two at a time: name -> (outcome, its directory)."""
    dirs = {name: tmp_path_factory.mktemp(name) for name in JOBS}
    with concurrent.futures.ThreadPoolExecutor(JOBS_AT_ONCE) as pool:
        futures = {name: pool.submit(JOBS[name], dirs[name])
                   for name in JOBS}
        return {name: (f.result(), dirs[name]) for name, f in futures.items()}


def test_static_world_completes(jobs):
    rc, d = jobs["static"]
    assert rc == 0, _results(d)
    lines = _results(d)
    assert len(lines) == 2
    assert all("final_size=2" in ln for ln in lines)
    assert all("total=12.0" in ln for ln in lines)  # 6 steps of size 2


def test_scale_up(jobs):
    rc, d = jobs["scale_up"]
    assert rc == 0, _results(d)
    lines = _results(d)
    assert len(lines) == 3, lines
    assert all("final_size=3" in ln for ln in lines), lines


def test_worker_failure_blacklists_and_recovers(jobs):
    rc, d = jobs["failure"]
    assert rc == 0, _results(d)
    assert (d / "crashed.marker").exists()
    finishers = [ln for ln in _results(d) if "final_size=2" in ln]
    assert len(finishers) == 2, _results(d)
    assert all(ln.startswith("localhost:") for ln in finishers), finishers


def test_scale_down(jobs):
    rc, d = jobs["scale_down"]
    assert rc == 0, _results(d)
    finishers = [ln for ln in _results(d) if "final_size=" in ln]
    assert len(finishers) == 2, _results(d)
    assert all("final_size=2" in ln for ln in finishers), finishers


def test_rendezvous_timeout_when_min_np_unreachable(jobs):
    (out, seconds), _ = jobs["rendezvous_timeout"]
    assert isinstance(out, TimeoutError) and "at least 3 slots" in str(out)
    assert seconds < 30


def test_reset_limit_aborts(jobs):
    rc, d = jobs["reset_limit"]
    assert isinstance(rc, int) and rc != 0, rc


def _finishers(d):
    out = {}
    for name in os.listdir(d):
        if name.startswith("final."):
            with open(os.path.join(d, name), "rb") as f:
                out[name[len("final."):]] = pickle.load(f)
    return out


def test_torch_state_recovery_matches_jax(jobs):
    """Both packages: rc 0, two finishers on ``localhost`` at size 2 after
    8 batches, the same weights on both, each survivor's weights after its
    restore and sync bitwise its commit of batch 3, and the two packages'
    final weights within rtol 1e-4, atol 1e-5."""
    finals = {}
    for pkg in ("port", "jax"):
        rc, d = jobs[f"torch_{pkg}"]
        leg = f"leg torch_{pkg}, {d / 'results.txt'}"
        assert rc == 0, (leg, rc, _results(d))
        fin = _finishers(d)
        assert sorted(fin) == ["localhost:0", "localhost:1"], (leg, fin)
        for wid, res in fin.items():
            assert (res["size"], res["batch"]) == (2, MLP_BATCHES), \
                (leg, wid, res["size"], res["batch"])
            # Every sync after a reset holds the weights of the commit it
            # went back to, the one of the failed batch among them.
            syncs = [(b, h) for b, h in res["restored"] if b > 0]
            why = (leg, wid, syncs, sorted(res["committed"]),
                   res["resets"])
            assert MLP_CRASH_AT in [b for b, _ in syncs], why
            assert all(h == res["committed"].get(b) for b, h in syncs), why
        a, b = fin["localhost:0"]["weights"], fin["localhost:1"]["weights"]
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), leg
        finals[pkg] = a
    for got, want in zip(finals["port"], finals["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _counter_worker() -> None:
    """tests/data/elastic_worker.py on the port: an ObjectState counter,
    a Sum allreduce of ones a step, committed every step."""
    import torch

    import horovod_tpu_torch as hvd
    target = int(os.environ.get("ELASTIC_TARGET_BATCHES", "12"))
    pause = float(os.environ.get("ELASTIC_BATCH_SLEEP", "0"))
    crash_at = os.environ.get("ELASTIC_CRASH_AT")
    marker = os.environ.get("ELASTIC_CRASH_MARKER", "")
    hvd.init(device="cpu")
    state = hvd.elastic.ObjectState(batches=0, total=0.0)

    @hvd.elastic.run
    def train(state):
        while state.batches < target:
            wid = os.environ.get("HVDTPU_WORKER_ID", "")
            if crash_at and not os.path.exists(marker):
                crash_wid, crash_batch = crash_at.rsplit(":", 1)
                if wid == crash_wid and state.batches == int(crash_batch):
                    with open(marker, "w") as f:
                        f.write("crashed\n")
                    os._exit(7)
            out = hvd.allreduce(torch.ones(8), name=f"step{state.batches}",
                                op=hvd.Sum)
            state.total += float(out[0])  # the size at that step
            state.batches += 1
            state.commit()
            if pause:
                time.sleep(pause)
        return hvd.size()

    final_size = train(state)
    with open(os.environ["ELASTIC_RESULT_FILE"], "a") as f:
        f.write(f"{os.environ.get('HVDTPU_WORKER_ID')} rank={hvd.rank()} "
                f"final_size={final_size} batches={state.batches} "
                f"total={state.total}\n")
    # A rank that shuts its core down while a peer still reads its last
    # bytes breaks that peer: join first.
    hvd.join()
    hvd.shutdown()


def _digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def _torch_worker(pkg: str) -> None:
    """The MLP job of either package: rank r's batch b from seed
    (b, r), SGD with momentum through the package's DistributedOptimizer,
    a TorchState committed every batch; ``127.0.0.1:0`` dies before its
    step of batch ``MLP_CRASH_AT``. Each worker records the digest of
    every commit and of its weights after each sync, and the finishers
    their weights."""
    import torch

    if pkg == "port":
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        TorchState = hvd.elastic.TorchState
    else:
        import horovod_tpu.torch as hvd
        from horovod_tpu.torch.elastic import TorchState
        hvd.init()
    out = os.environ["ELASTIC_OUT"]
    wid = os.environ["HVDTPU_WORKER_ID"]
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=MLP_LR, momentum=0.9),
        named_parameters=model.named_parameters())
    committed, restored, resets = {}, [], []

    class State(TorchState):
        def sync(self):
            super().sync()
            restored.append((self.batch, _digest(model)))

        def restore(self):
            super().restore()
            resets.append(("restore", self.batch))

        def check_host_updates(self):
            try:
                super().check_host_updates()
            except Exception as exc:
                resets.append((type(exc).__name__, self.batch))
                raise

    state = State(model, opt, batch=0)

    @hvd.elastic.run
    def train(state):
        while state.batch < MLP_BATCHES:
            if wid == "127.0.0.1:0" and state.batch == MLP_CRASH_AT:
                os._exit(7)
            rng = np.random.RandomState(1000 * state.batch + hvd.rank())
            x = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
            y = torch.from_numpy(rng.randn(4, 4).astype(np.float32))
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            opt.step()
            state.batch += 1
            # Before the commit, which may raise HostsUpdatedInterrupt
            # after it has saved this state.
            committed[state.batch] = _digest(model)
            state.commit()
        return hvd.size()

    size = train(state)
    with open(os.path.join(out, f"final.{wid}"), "wb") as f:
        pickle.dump({"size": size, "batch": state.batch,
                     "committed": committed,
                     "restored": restored, "resets": resets,
                     "weights": [p.detach().numpy().copy()
                                 for p in model.parameters()]}, f)
    hvd.join()
    hvd.shutdown()


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    kind = os.environ["HVDTPU_TEST_WORKER"]
    if kind == "counter":
        _counter_worker()
    else:
        _torch_worker(kind[len("torch_"):])
