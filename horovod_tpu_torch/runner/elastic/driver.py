"""The elastic driver: discovery, rendezvous rounds and the workers' lives
(counterpart of ``horovod_tpu/runner/elastic/driver.py``:
``ElasticSettings`` :49, ``ElasticDriver`` :82, ``_rendezvous`` :231, the
settle watchdog :292, spawn and watch :390-458, ``run_elastic`` :460;
reference: ``horovod/runner/elastic/driver.py``).

The driver serves a :class:`~horovod_tpu_torch.runner.http_kv.KVStoreServer`
that the workers poll; its keys are the JAX driver's:

* ``/rendezvous/epoch``: the current round, growing;
* ``/rendezvous/{epoch}/assignment/{worker_id}``: a worker's topology in
  that round (JSON: rank, size, local and cross ranks, the controller's
  address and port), for the stable identity ``host:slot``;
* ``/rendezvous/{epoch}/ready/{worker_id}``: the worker's claim of it;
* ``/rendezvous/updates``: the last round with a change of membership,
  which workers read at every ``state.commit()``;
* ``/rendezvous/hint``: a worker's report of a failed peer.

A worker enters a round by waiting for an epoch newer than the one it last
initialized with (:func:`horovod_tpu_torch.runtime.init`). The driver
keeps the hosts of the last round first, in their order, and puts new ones
after them: rank 0, whose state ``sync()`` broadcasts, stays on a worker
that trained (the reference's ``DiscoveredHosts`` keeps the same order;
the JAX driver sorts the hosts by name, so a new host whose name sorts
first would take rank 0 there).

With ``metrics_base`` (``hvdrun-torch --metrics-port``) the driver also
watches the ``hvdtpu_dead_ranks`` gauge of rank 0's ``/metrics`` (JAX
``driver.py:112-133``, :200-215): rank 0 is the coordinator, which counts
the peers it lost, and the watch follows each round's rank 0. A dead rank
it reports starts a round, once a round, even where no worker could post
a hint. It reads a round only once every worker has claimed it: until
then rank 0's endpoint may still be its last world's, whose gauge counts
the death a round already answers (the JAX driver's watch reads it and
starts round after round). Each round's first read is logged at info
level.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from typing import Dict, List, Optional, Set

from ...utils import envvars as ev
from ...utils import logging as log
from .. import safe_exec
from ..hosts import get_host_assignments
from ..http_kv import KVStoreServer
from .discovery import HostDiscovery, HostManager
from .registration import FAILURE, SUCCESS, WorkerStateRegistry


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _is_loopback(hostname: str) -> bool:
    return hostname in ("localhost", "127.0.0.1")


@dataclasses.dataclass
class ElasticSettings:
    """The job's bounds and the driver's clocks (the JAX driver's
    defaults)."""
    min_np: int
    max_np: int
    discovery_interval_s: float = 1.0
    elastic_timeout_s: float = 600.0
    reset_limit: Optional[int] = None
    # The interpreter for the {python} placeholder on other hosts.
    remote_python: str = "python3"
    # Workers post /rendezvous/hint as soon as they see a peer fail, so it
    # is read far more often than discovery runs: this bounds how long a
    # failure waits for its new round.
    hint_poll_interval_s: float = 0.2
    # Once a worker of a new round has claimed it, a worker carried over
    # from the last round that has still not claimed after this long is
    # wedged in the old world (healthy peers reach the commit together) and
    # is replaced. Workers spawned for the round are exempt: starting the
    # interpreter, torch and a CUDA context can take longer.
    settle_timeout_s: float = 10.0
    # A worker identity replaced more than this often gets its host
    # blacklisted; each replacement waits base * 2^(n-1) s, at most 8 s.
    max_respawns: int = 3
    respawn_backoff_s: float = 0.5


class ElasticDriver:
    """Supervises one elastic job."""

    def __init__(self, discovery: HostDiscovery, settings: ElasticSettings,
                 command: List[str], env: Dict[str, str],
                 verbose: bool = False, metrics_base: Optional[int] = None):
        self._host_manager = HostManager(discovery)
        self._settings = settings
        self._command = command
        self._base_env = dict(env)
        self._verbose = verbose
        # One secret for the store and every worker.
        self._secret = env.get(ev.HVDTPU_SECRET) or \
            ev.get_str(ev.HVDTPU_SECRET)
        if self._secret:
            self._base_env[ev.HVDTPU_SECRET] = self._secret
        self._kv = KVStoreServer(secret=self._secret)
        self._registry = WorkerStateRegistry()
        self._epoch = 0
        self._procs: Dict[str, safe_exec.WorkerProcess] = {}
        self._expected: Set[str] = set()
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        self._result: Optional[int] = None
        self._result_event = threading.Event()
        self._respawns: Dict[str, int] = {}
        self._last_rendezvous = 0.0
        # The hosts (in rank order) of the last round: the discovery loop
        # starts a round only when the usable set differs from them, so a
        # blacklist that _watch already handled is not a second change.
        self._last_hosts: Dict[str, int] = {}
        self._discovery_thread: Optional[threading.Thread] = None
        self._closed = False
        # The last round every worker of which has claimed it.
        self._formed_epoch = 0
        # The watch of rank 0's /metrics: its base port, the current
        # round's rank-0 host, and the last round it started a new one
        # for.
        self._metrics_base = metrics_base
        self._metrics_thread: Optional[threading.Thread] = None
        self._controller_host: Optional[str] = None
        self._metrics_epoch_triggered = 0

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._kv.start()
        self._wait_for_available_slots()
        self._rendezvous("initial")
        self._discovery_thread = threading.Thread(
            target=self._discovery_loop, daemon=True)
        self._discovery_thread.start()
        if self._metrics_base:
            self._metrics_thread = threading.Thread(
                target=self._metrics_monitor_loop, daemon=True)
            self._metrics_thread.start()

    def wait_for_completion(self, timeout: Optional[float] = None) -> int:
        """Wait for the job's end, stop every worker left, and return the
        job's code; after ``timeout`` seconds, stop it all and raise
        TimeoutError."""
        finished = self._result_event.wait(timeout)
        self.close()
        if not finished:
            raise TimeoutError(f"the elastic job did not end within "
                               f"{timeout} s")
        return self._result if self._result is not None else 1

    def close(self) -> None:
        """Stop the workers (their whole process groups), the discovery
        loop and the store; a second call does nothing."""
        if self._closed:
            return
        self._closed = True
        self._shutdown.set()
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            p.terminate()
        for thread in (self._discovery_thread, self._metrics_thread):
            if thread is not None:
                thread.join(timeout=5)
        self._kv.stop()

    @property
    def kv_port(self) -> int:
        return self._kv.port

    def _finish(self, code: int) -> None:
        self._result = code
        self._result_event.set()

    # ------------------------------------------------------------------
    def _wait_for_available_slots(self) -> None:
        deadline = time.time() + self._settings.elastic_timeout_s
        while time.time() < deadline:
            self._host_manager.update_available_hosts()
            total = sum(self._host_manager.current_hosts.values())
            if total >= self._settings.min_np:
                return
            time.sleep(self._settings.discovery_interval_s)
        raise TimeoutError(
            f"timed out waiting for at least {self._settings.min_np} slots")

    def _discovery_loop(self) -> None:
        """Failure hints every ``hint_poll_interval_s``, discovery (which
        may run a script) every ``discovery_interval_s``.

        A hint comes from a survivor that saw a peer's connection break,
        usually because the peer exited, and the peer's exit must be
        handled first (its host blacklisted): a round started from the
        hint alone would keep the dead worker's slot, start it again and
        leave its host in the job. So a hint acts only when it is one
        tick old and no round has started since it came; a dead worker's
        exit, seen by :meth:`_watch` or reaped here, starts the round.
        Every survivor of one failure posts a hint, and a hint read
        within a second of a round is that round's failure (the JAX
        driver's rule); so is a hint that comes while the current round
        has not formed yet: its survivors are on their way to it (a
        survivor sees the failure only at its next collective)."""
        hint_tick = max(self._settings.hint_poll_interval_s, 0.05)
        next_discovery = time.monotonic()
        hint = None  # (who, time.monotonic() when read)
        while not self._shutdown.wait(hint_tick):
            discovered = False
            if time.monotonic() >= next_discovery:
                next_discovery = (time.monotonic() +
                                  self._settings.discovery_interval_s)
                try:
                    self._host_manager.update_available_hosts()
                    discovered = True
                except (RuntimeError, OSError, ValueError,
                        TimeoutError) as e:
                    log.warning("elastic: discovery failed: %s", e)
            posted = self._kv.get("/rendezvous/hint")
            if posted:
                self._kv.put("/rendezvous/hint", b"")
                if hint is None and \
                        time.monotonic() - self._last_rendezvous > 1.0:
                    hint = (posted.decode(errors="replace"),
                            time.monotonic())
            with self._lock:
                if self._shutdown.is_set():
                    return
                for worker_id, proc in list(self._procs.items()):
                    rc = proc.poll()
                    if rc is not None:
                        self._handle_exit(worker_id, proc, rc)
                if hint is not None and hint[1] <= self._last_rendezvous:
                    hint = None  # a round already answered that failure
                if discovered and (self._host_manager.current_hosts !=
                                   self._last_hosts):
                    self._rendezvous("host set changed")
                elif hint is not None and \
                        time.monotonic() - hint[1] >= hint_tick:
                    if self._formed_epoch == self._epoch:
                        self._rendezvous(f"failure hint from {hint[0]}")
                    hint = None

    def _metrics_monitor_loop(self) -> None:
        """Scrape the current round's rank 0 and start a round when its
        ``hvdtpu_dead_ranks`` is above 0: a failure is then handled even
        when every survivor is blocked in a collective and none posts a
        hint."""
        from ...observability import (parse_prometheus_text, sample_value,
                                      scrape)
        interval = max(self._settings.hint_poll_interval_s * 2, 0.5)
        logged = 0
        while not self._shutdown.wait(interval):
            with self._lock:
                host, epoch = self._controller_host, self._epoch
                formed = self._formed_epoch == epoch
            if not host or not formed or \
                    epoch <= self._metrics_epoch_triggered:
                continue
            try:
                text = scrape(host, self._metrics_base, secret=self._secret,
                              timeout=2.0)
            except Exception:
                continue  # rank 0 is not up yet, or starts again
            dead = sample_value(parse_prometheus_text(text),
                                "hvdtpu_dead_ranks") or 0
            if epoch > logged:
                logged = epoch
                log.info("elastic: epoch %d: rank 0's /metrics on %s:%d "
                         "reads hvdtpu_dead_ranks %d", epoch, host,
                         self._metrics_base, int(dead))
            if dead > 0:
                log.warning("elastic: metrics report %d dead rank(s); "
                            "re-forming", int(dead))
                with self._lock:
                    if self._shutdown.is_set() or epoch != self._epoch:
                        continue  # a round has started since
                    self._metrics_epoch_triggered = epoch
                    self._rendezvous("dead rank reported by metrics")

    def _usable_hosts(self) -> Dict[str, int]:
        """The hosts of the last discovery less those blacklisted since:
        a failure starts its round at once, without running discovery
        again."""
        return {h: s for h, s in self._host_manager.current_hosts.items()
                if not self._host_manager.is_blacklisted(h)}

    def _ordered_hosts(self, hosts: Dict[str, int]) -> List:
        """The usable hosts in rank order: the last round's first, as they
        were, then the new ones by name."""
        kept = [(h, hosts[h]) for h in self._last_hosts if h in hosts]
        new = sorted((h, s) for h, s in hosts.items()
                     if h not in self._last_hosts)
        return kept + new

    def _rendezvous(self, reason: str) -> None:
        """Start a round: assign ranks, publish the assignments, then the
        epoch, and start the workers the round lacks."""
        with self._lock:
            if (self._settings.reset_limit is not None and
                    self._epoch >= self._settings.reset_limit + 1):
                log.warning("elastic: reset limit reached; aborting")
                self._finish(1)
                return
            hosts = self._usable_hosts()
            total = sum(hosts.values())
            if total < self._settings.min_np:
                self._last_hosts = dict(hosts)
                log.warning("elastic: only %d slots (< min_np %d); waiting",
                            total, self._settings.min_np)
                return
            np_ = min(total, self._settings.max_np)
            host_list = self._ordered_hosts(hosts)
            self._last_hosts = dict(host_list)
            slots = get_host_assignments(host_list, np_)
            self._epoch += 1
            epoch = self._epoch
            controller_port = _free_port()
            expected = set()
            for s in slots:
                worker_id = f"{s.hostname}:{s.local_rank}"
                expected.add(worker_id)
                assignment = {
                    "rank": s.rank, "size": s.size,
                    "local_rank": s.local_rank, "local_size": s.local_size,
                    "cross_rank": s.cross_rank, "cross_size": s.cross_size,
                    "controller_addr": slots[0].hostname,
                    "controller_port": controller_port,
                    "epoch": epoch,
                }
                self._kv.put(f"/rendezvous/{epoch}/assignment/{worker_id}",
                             json.dumps(assignment).encode())
            self._expected = expected
            self._controller_host = slots[0].hostname
            self._last_rendezvous = time.monotonic()
            # Workers running when the round is published must claim it;
            # they are taken before the publish, for the settle watchdog.
            carried = {wid: p for wid, p in self._procs.items()
                       if wid in expected and p.poll() is None}
            self._kv.put("/rendezvous/epoch", str(epoch).encode())
            self._kv.put("/rendezvous/updates", str(epoch).encode())
            log.info("elastic: rendezvous epoch %d (%s): %d workers on %s",
                     epoch, reason, np_, [h for h, _ in host_list])
            for s in slots:
                worker_id = f"{s.hostname}:{s.local_rank}"
                proc = self._procs.get(worker_id)
                if proc is None or proc.poll() is not None:
                    self._spawn(worker_id, s.hostname)
            threading.Thread(target=self._watch_formation,
                             args=(epoch, sorted(expected), reason),
                             daemon=True).start()
            if carried:
                threading.Thread(target=self._settle_watchdog,
                                 args=(epoch, carried), daemon=True).start()

    def _claimed(self, epoch: int, worker_id: str) -> bool:
        return bool(self._kv.get(f"/rendezvous/{epoch}/ready/{worker_id}"))

    def _watch_formation(self, epoch: int, expected: List[str],
                         reason: str) -> None:
        """Mark the round formed when every worker of it has claimed it
        (their cores then start), and log it at info level."""
        t0 = time.monotonic()
        while not self._shutdown.wait(0.02):
            if self._epoch != epoch:
                return
            if all(self._claimed(epoch, wid) for wid in expected):
                with self._lock:
                    if self._epoch == epoch:
                        self._formed_epoch = epoch
                log.info("elastic: epoch %d (%s) formed: %d workers claimed "
                         "it %.3f s after its rendezvous", epoch, reason,
                         len(expected), time.monotonic() - t0)
                return

    def _settle_watchdog(self, epoch: int,
                         carried: Dict[str, safe_exec.WorkerProcess]) -> None:
        """Replace the carried-over workers that never claim the round.

        A healthy worker claims at its next commit, and collectives keep
        healthy peers at the same commit, so the clock starts only once
        one worker of the round has claimed (after a scale-up every
        carried worker may be a whole step from its commit). A worker
        still unclaimed ``settle_timeout_s`` later is wedged in the old
        world (a hung collective, a blocked call) and would hold its slot
        forever: it is stopped and started again, with backoff, and its
        host is blacklisted past ``max_respawns``."""
        slice_s = max(0.05, min(0.5, self._settings.settle_timeout_s / 4))
        first_claim = None
        while True:
            if self._shutdown.wait(slice_s):
                return
            with self._lock:
                if self._shutdown.is_set() or self._epoch != epoch:
                    return
                expected = set(self._expected)
                unsettled = [wid for wid, p in carried.items()
                             if self._procs.get(wid) is p and
                             p.poll() is None and
                             not self._claimed(epoch, wid)]
            if not unsettled:
                return  # all claimed or exited (_watch handles exits)
            if first_claim is None and any(self._claimed(epoch, wid)
                                           for wid in expected):
                first_claim = time.monotonic()
            if first_claim is not None and (
                    time.monotonic() - first_claim >=
                    self._settings.settle_timeout_s):
                break
        for worker_id, proc in carried.items():
            blacklist_host = None
            with self._lock:
                if self._shutdown.is_set() or self._epoch != epoch:
                    return
                if self._claimed(epoch, worker_id):
                    continue
                if self._procs.get(worker_id) is not proc or \
                        proc.poll() is not None:
                    continue
                count = self._respawns.get(worker_id, 0) + 1
                self._respawns[worker_id] = count
                # Detached first, so that its _watch does not take the
                # stop for a failure.
                self._procs.pop(worker_id, None)
                host = worker_id.rsplit(":", 1)[0]
                if count > self._settings.max_respawns:
                    blacklist_host = host
                else:
                    log.warning(
                        "elastic: worker %s never claimed epoch %d "
                        "(wedged?); terminating and respawning (%d/%d)",
                        worker_id, epoch, count, self._settings.max_respawns)
            proc.terminate()
            if blacklist_host is not None:
                log.warning("elastic: worker %s exceeded %d respawns; "
                            "blacklisting host %s", worker_id,
                            self._settings.max_respawns, blacklist_host)
                with self._lock:
                    self._host_manager.blacklist(blacklist_host)
                    total = sum(self._usable_hosts().values())
                    if total < self._settings.min_np:
                        log.warning("elastic: below min_np after blacklist; "
                                    "aborting")
                        self._finish(1)
                    else:
                        self._rendezvous(f"worker {worker_id} wedged past "
                                         "the respawn cap")
                continue
            backoff = min(self._settings.respawn_backoff_s *
                          (2 ** (self._respawns.get(worker_id, 1) - 1)), 8.0)
            if self._shutdown.wait(backoff):
                return
            with self._lock:
                if self._shutdown.is_set() or self._epoch != epoch:
                    return
                if worker_id in self._expected and \
                        worker_id not in self._procs:
                    self._spawn(worker_id, worker_id.rsplit(":", 1)[0])

    def _spawn(self, worker_id: str, hostname: str) -> None:
        env = dict(self._base_env)
        local_name = "127.0.0.1" if _is_loopback(hostname) else None
        env[ev.HVDTPU_RENDEZVOUS_ADDR] = local_name or socket.gethostname()
        env[ev.HVDTPU_RENDEZVOUS_PORT] = str(self._kv.port)
        env[ev.HVDTPU_WORKER_ID] = worker_id
        env[ev.HVDTPU_HOSTNAME] = local_name or hostname
        if env.get(ev.HVDTPU_TIMELINE):
            # Ranks change between rounds: the suffix is the worker's id.
            env[ev.HVDTPU_TIMELINE] = (f"{env[ev.HVDTPU_TIMELINE]}."
                                       f"{worker_id.replace(':', '_')}.json")
        if self._verbose:
            log.info("elastic: spawning %s", worker_id)
        local = safe_exec.is_local_host(hostname)
        cmd = safe_exec.resolve_python(self._command, local,
                                       self._settings.remote_python)
        stdin_data = None
        if local:
            command = cmd
        else:
            # Over ssh, as the static launcher; the controller's port was
            # drawn on this host, so rank 0's host may find it taken, in
            # which case rank 0 fails and the job goes to a new round.
            env[ev.HVDTPU_RENDEZVOUS_ADDR] = socket.gethostname()
            command = safe_exec.ssh_wrap(hostname, 22, env, cmd)
            if self._secret:
                stdin_data = (self._secret + "\n").encode()
        proc = safe_exec.WorkerProcess(command, env, worker_id,
                                       stdin_data=stdin_data)
        self._procs[worker_id] = proc
        threading.Thread(target=self._watch, args=(worker_id, proc),
                         daemon=True).start()

    def _watch(self, worker_id: str, proc: safe_exec.WorkerProcess) -> None:
        rc = proc.wait()
        if self._shutdown.is_set():
            return
        with self._lock:
            self._handle_exit(worker_id, proc, rc)

    def _handle_exit(self, worker_id: str, proc: safe_exec.WorkerProcess,
                     rc: int) -> None:
        """A worker's exit, once (the caller holds the lock): 0 counts
        toward the job's success; anything else blacklists its host and
        starts a round without it (reference: ``driver.py:291-307``)."""
        if self._shutdown.is_set() or self._procs.get(worker_id) is not proc:
            return  # replaced, or handled already
        epoch = self._epoch
        host = worker_id.rsplit(":", 1)[0]
        if rc == 0:
            self._procs.pop(worker_id)
            self._registry.record(epoch, worker_id, SUCCESS)
            if self._registry.all_succeeded(epoch, self._expected):
                self._finish(0)
            return
        log.warning("elastic: worker %s failed (rc=%d); blacklisting "
                    "host %s", worker_id, rc, host)
        self._registry.record(epoch, worker_id, FAILURE)
        self._procs.pop(worker_id)
        self._host_manager.blacklist(host)
        total = sum(self._usable_hosts().values())
        if total < self._settings.min_np:
            log.warning("elastic: below min_np after blacklist; aborting")
            self._finish(rc)
        else:
            self._rendezvous(f"worker {worker_id} failed")


def run_elastic(discovery: HostDiscovery, settings: ElasticSettings,
                command: List[str], env: Dict[str, str],
                verbose: bool = False,
                metrics_base: Optional[int] = None) -> int:
    """Run an elastic job to its end; its exit code."""
    driver = ElasticDriver(discovery, settings, command, env, verbose,
                           metrics_base=metrics_base)
    try:
        driver.start()
        return driver.wait_for_completion()
    finally:
        driver.close()
