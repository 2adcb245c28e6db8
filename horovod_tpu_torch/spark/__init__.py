"""Spark integration: run ``horovod_tpu_torch`` training inside Spark
tasks.

Counterpart of ``horovod_tpu/spark/__init__.py`` (reference:
``horovod/spark/runner.py:195``, ``run``) — one Horovod worker per Spark
task slot; the driver hosts a rendezvous service, tasks register their
hosts, receive rank assignments, and execute the training function under
the distributed runtime. The rendezvous rides the port's HTTP KV store
(:mod:`horovod_tpu_torch.runner.http_kv`) and each task starts the port's
native core (``init(mode="process")``) — no MPI, no driver/task NIC
discovery (the KV server address is the single coordination endpoint).
``device`` (of ``run``, ``run_elastic`` and the task bodies) is where each
task's runtime runs: by default the card of its local rank, ``"cpu"`` on
the CPU.

Import-gated: requires ``pyspark`` only when actually used.
"""

from __future__ import annotations

import os
import pickle
import socket
import time
from typing import Any, Callable, Optional

from ..utils import envvars as ev

__all__ = ["run", "run_elastic", "Store", "LocalStore", "FilesystemStore",
           "HDFSStore", "DBFSLocalStore", "PandasDataFrame",
           "Estimator", "EstimatorModel", "TorchEstimator", "TorchModel"]

from .store import (Store, LocalStore, FilesystemStore,  # noqa: E402,F401
                    HDFSStore, DBFSLocalStore)
from .pandas_df import PandasDataFrame  # noqa: E402,F401


def __getattr__(name):
    # Estimators re-exported where reference users look for them
    # (``horovod.spark.keras.KerasEstimator`` / ``horovod.spark.torch
    # .TorchEstimator``) — lazily, so importing the spark runner never
    # drags in the models and the training loops.
    if name in ("Estimator", "EstimatorModel"):
        from ..integrations import estimator as _e
        return getattr(_e, name)
    if name in ("TorchEstimator", "TorchModel"):
        from ..torch import estimator as _te
        return getattr(_te, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

_POLL_S = 0.25


def _local_addr() -> str:
    """An address executors can reach the driver on, overridable via
    HVDTPU_ADVERTISE_ADDR (reference: driver_service address collection,
    horovod/runner/driver/driver_service.py)."""
    from ..runner.preflight import local_addr
    return local_addr()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_kv(client, key: str, deadline: float) -> bytes:
    while True:
        val = client.get(key)
        if val is not None:
            return val
        if time.monotonic() > deadline:
            raise TimeoutError(f"rendezvous timed out waiting for {key!r}")
        time.sleep(_POLL_S)


def _require_spark_context(what: str):
    """Import-gate pyspark and fetch the active SparkContext."""
    try:
        from pyspark import SparkContext
    except ImportError as e:
        raise ImportError(
            f"horovod_tpu_torch.spark.{what} requires pyspark "
            "(pip install pyspark)") from e
    sc = SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("no active SparkContext; create a SparkSession "
                           f"before calling horovod_tpu_torch.spark.{what}")
    return sc


def _cloudpickle_payload(fn, args, kwargs) -> bytes:
    """cloudpickle (shipped with pyspark): plain pickle cannot serialize the
    nested/closure functions users normally pass as ``fn``."""
    try:
        from pyspark import cloudpickle as _cp
    except ImportError:  # very old pyspark layouts
        import pyspark.cloudpickle as _cp
    return _cp.dumps((fn, args, dict(kwargs or {})))


def _env_with_job_secret(env: Optional[dict]) -> dict:
    """One HMAC secret shared by the KV server and every task; the
    caller-supplied env wins so both sides always agree."""
    import secrets as _secrets
    env = dict(env or {})
    env["HVDTPU_SECRET"] = env.get("HVDTPU_SECRET") or \
        ev.get_str(ev.HVDTPU_SECRET) or _secrets.token_hex(16)
    return env


def _rank_layout(hosts: list, rank: int):
    """local/cross rank assignment from the per-rank host list (reference:
    common/util/hosts.py get_host_assignments)."""
    same = [i for i in range(len(hosts)) if hosts[i] == hosts[rank]]
    unique_hosts = list(dict.fromkeys(hosts))
    return (same.index(rank), len(same),
            unique_hosts.index(hosts[rank]), len(unique_hosts))


class _scoped_environ:
    """Apply env updates for the task body and restore the previous values on
    exit — pyspark reuses python worker processes across tasks
    (``spark.python.worker.reuse``), so leaked ``HVDTPU_*`` would flip a
    later, unrelated task into process/elastic mode."""

    def __init__(self, updates: dict):
        self._updates = dict(updates)
        self._saved: dict = {}

    def __enter__(self):
        for k, v in self._updates.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, prev in self._saved.items():
            if prev is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = prev
        return False


def _spark_task(rank: int, num_proc: int, kv_addr: str, kv_port: int,
                payload: bytes, start_timeout: float, env: Optional[dict],
                device=None):
    """Body of one Spark task == one Horovod rank (reference:
    horovod/spark/task/task_service.py + gloo exec; here: register host in
    the KV store, derive local/cross ranks, start the native core on
    ``device``)."""
    from ..runner.http_kv import KVStoreClient

    deadline = time.monotonic() + start_timeout
    secret = (env or {}).get("HVDTPU_SECRET") or ev.get_str(ev.HVDTPU_SECRET)
    client = KVStoreClient(kv_addr, kv_port, timeout=10.0, secret=secret)
    me = _local_addr()
    client.put(f"/spark/host/{rank}", me.encode())

    hosts = [
        _wait_kv(client, f"/spark/host/{i}", deadline).decode()
        for i in range(num_proc)
    ]

    local_rank, local_size, cross_rank, cross_size = _rank_layout(hosts, rank)

    if rank == 0:
        port = _free_port()
        client.put("/spark/controller", f"{me}:{port}".encode())
    ctrl = _wait_kv(client, "/spark/controller", deadline).decode()
    ctrl_addr, ctrl_port = ctrl.rsplit(":", 1)

    task_env = {
        "HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(num_proc),
        "HVDTPU_LOCAL_RANK": str(local_rank),
        "HVDTPU_LOCAL_SIZE": str(local_size),
        "HVDTPU_CROSS_RANK": str(cross_rank),
        "HVDTPU_CROSS_SIZE": str(cross_size),
        "HVDTPU_CONTROLLER_ADDR": ctrl_addr,
        "HVDTPU_CONTROLLER_PORT": ctrl_port,
        "HVDTPU_HOSTNAME": me,
    }
    task_env.update(env or {})

    from .. import runtime as hvd

    fn, args, kwargs = pickle.loads(payload)
    with _scoped_environ(task_env):
        hvd.shutdown()
        hvd.init(mode="process", device=device)
        try:
            result = fn(*args, **kwargs)
        finally:
            hvd.shutdown()
    return rank, result


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        num_proc: Optional[int] = None, start_timeout: float = 120.0,
        env: Optional[dict] = None, verbose: bool = False,
        device=None) -> list:
    """Run ``fn`` on ``num_proc`` Horovod ranks placed as Spark tasks.

    Reference: ``horovod.spark.run`` (``horovod/spark/runner.py:195``) —
    returns the list of results ordered by rank. ``num_proc`` defaults to
    ``sc.defaultParallelism`` like the reference.
    """
    sc = _require_spark_context("run")
    n = num_proc or sc.defaultParallelism
    payload = _cloudpickle_payload(fn, args, kwargs)
    env = _env_with_job_secret(env)

    from ..runner.http_kv import KVStoreServer
    from ..utils import logging as log

    server = KVStoreServer(port=0, secret=env["HVDTPU_SECRET"])
    server.start()
    kv_addr, kv_port = _local_addr(), server.port
    if verbose:
        log.info("spark: rendezvous KV at %s:%d, %d ranks", kv_addr, kv_port, n)
    try:
        rdd = sc.parallelize(range(n), n)
        results = rdd.mapPartitionsWithIndex(
            lambda index, _it: [_spark_task(index, n, kv_addr, kv_port,
                                            payload, start_timeout, env,
                                            device)],
            preservesPartitioning=True).collect()
    finally:
        server.stop()
    return [result for _rank, result in sorted(results)]


def _elastic_spark_task(index: int, kv_addr: str, kv_port: int,
                        payload: bytes, env: Optional[dict], device=None):
    """Body of one elastic Spark task: heartbeat membership into the driver's
    KV store, then run the (elastic-wrapped) training function under the
    standard worker-side elastic protocol — the runtime polls
    ``/rendezvous/*`` for its assignment exactly as under ``hvdrun-torch``
    (``runtime._elastic_assignment``)."""
    import threading

    from ..runner.http_kv import KVStoreClient
    from .elastic import heartbeat_loop

    me = _local_addr()
    worker_id = f"{me}:task{index}"
    secret = (env or {}).get("HVDTPU_SECRET") or \
        ev.get_str(ev.HVDTPU_SECRET)
    client = KVStoreClient(kv_addr, kv_port, timeout=10.0, secret=secret)
    stop_beat = threading.Event()
    threading.Thread(target=heartbeat_loop,
                     args=(client, worker_id, me),
                     kwargs={"stop": stop_beat}, daemon=True).start()

    task_env = {
        "HVDTPU_RENDEZVOUS_ADDR": kv_addr,
        "HVDTPU_RENDEZVOUS_PORT": str(kv_port),
        "HVDTPU_WORKER_ID": worker_id,
        "HVDTPU_HOSTNAME": me,
    }
    task_env.update(env or {})

    from .. import runtime as hvd

    fn, args, kwargs = pickle.loads(payload)
    with _scoped_environ(task_env):
        hvd.shutdown()
        # Process mode (elastic); blocks in rendezvous until this worker is
        # assigned.
        hvd.init(device=device)
        try:
            result = fn(*args, **kwargs)
        finally:
            rank = hvd.rank()
            hvd.shutdown()
            stop_beat.set()
            # Reused pyspark workers outlive tasks: a later run_elastic()
            # in this process starts its epochs at 1 again, which the
            # stale-epoch guard would otherwise reject.
            hvd._elastic_last_epoch = 0
    return rank, result


def run_elastic(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
                num_proc: Optional[int] = None,
                min_np: Optional[int] = None, max_np: Optional[int] = None,
                start_timeout: float = 600.0, env: Optional[dict] = None,
                verbose: bool = False, device=None) -> list:
    """Elastic variant of :func:`run` (reference: ``horovod.spark.run_elastic``,
    ``horovod/spark/runner.py:303``): Spark supervises the workers (task
    retries / dynamic allocation); the driver only runs membership +
    rank-assignment rendezvous. ``fn`` should be an
    ``hvd.elastic.run``-wrapped training function taking an
    ``hvd.elastic.State``.

    Returns per-rank results of the final epoch's membership, ordered by rank.
    """
    sc = _require_spark_context("run_elastic")

    from .elastic import HeartbeatRendezvous
    from ..utils import logging as log

    n = num_proc or sc.defaultParallelism
    min_np = min_np or n
    max_np = max_np or n
    if n > max_np:
        # Excess tasks would never get an assignment, exit "scaled away",
        # and Spark's task-retry accounting would abort the healthy stage.
        raise ValueError(f"num_proc ({n}) must be <= max_np ({max_np}): "
                         "every launched Spark task is a training worker")

    payload = _cloudpickle_payload(fn, args, kwargs)
    env = _env_with_job_secret(env)
    env.setdefault("HVDTPU_ELASTIC_TIMEOUT", str(start_timeout))

    driver = HeartbeatRendezvous(min_np=min_np, max_np=max_np,
                                 secret=env["HVDTPU_SECRET"])
    driver.start()
    kv_addr = _local_addr()
    if verbose:
        log.info("spark elastic: rendezvous at %s:%d, np=[%d..%d]",
                 kv_addr, driver.port, min_np, max_np)
    try:
        rdd = sc.parallelize(range(n), n)
        results = rdd.mapPartitionsWithIndex(
            lambda index, _it: [_elastic_spark_task(index, kv_addr,
                                                    driver.port, payload,
                                                    env, device)],
            preservesPartitioning=True).collect()
    finally:
        driver.stop()
    return [result for _rank, result in sorted(results)]
