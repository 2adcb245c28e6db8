"""Elastic rendezvous for externally-supervised workers (Spark tasks).

A copy of ``horovod_tpu/spark/elastic.py`` over the port's store and host
assignment. Reference: ``horovod/spark/runner.py:303`` (``run_elastic``) — elastic
training where Spark owns worker placement/retries and Horovod's driver only
does membership + rank assignment.

Design: the port's :class:`~horovod_tpu_torch.runner.elastic.driver.
ElasticDriver` both *assigns ranks* and *spawns processes*. Inside Spark the
spawning half belongs to Spark (task retries, dynamic allocation), so this
module provides the rendezvous half only: workers heartbeat into the KV
store, and the driver publishes epochs/assignments under exactly the same
``/rendezvous/*`` key schema the workers' runtime already consumes
(``runtime._elastic_assignment``) — worker-side elastic code is identical
between ``hvdrun-torch`` and Spark.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Dict, Optional

from ..runner.hosts import get_host_assignments
from ..runner.http_kv import KVStoreServer
from ..utils import logging as log

_ALIVE_PREFIX = "/spark/elastic/alive/"
HEARTBEAT_INTERVAL_S = 0.5  # worker beat period (heartbeat_loop default)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class HeartbeatRendezvous:
    """Membership from KV heartbeats; assignment via ``/rendezvous/*`` keys.

    Workers PUT ``/spark/elastic/alive/{worker_id}`` (value: their hostname)
    every ``interval_s``; a worker whose heartbeat is older than
    ``heartbeat_timeout_s`` is considered gone. Any membership change starts
    a new rendezvous epoch (reference: driver.py:227 host-assignment update,
    minus process supervision).
    """

    def __init__(self, min_np: int, max_np: int,
                 secret: Optional[str] = None,
                 interval_s: float = 0.5,
                 heartbeat_timeout_s: float = 10.0):
        self.min_np = min_np
        self.max_np = max_np
        self._kv = KVStoreServer(secret=secret)
        self._interval = interval_s
        self._hb_timeout = heartbeat_timeout_s
        self._seen: Dict[str, float] = {}  # worker_id -> last heartbeat time
        self._beats: Dict[str, bytes] = {}  # worker_id -> last heartbeat value
        self._hosts: Dict[str, str] = {}   # worker_id -> hostname
        self._members: tuple = ()
        self._epoch = 0
        self._shutdown = threading.Event()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._kv.start()
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._kv.stop()

    @property
    def port(self) -> int:
        return self._kv.port

    @property
    def epoch(self) -> int:
        return self._epoch

    # ------------------------------------------------------------------
    def _poll_members(self, window: Optional[float] = None) -> tuple:
        now = time.monotonic()
        for key in self._kv.keys(_ALIVE_PREFIX):
            worker_id = key[len(_ALIVE_PREFIX):]
            val = self._kv.get(key)
            # KV keys persist; a worker counts as alive only while its
            # heartbeat VALUE keeps changing (each beat carries a fresh
            # timestamp — see heartbeat_loop).
            if val and val != self._beats.get(worker_id):
                self._beats[worker_id] = val
                self._seen[worker_id] = now
                self._hosts[worker_id] = val.decode().split("|", 1)[0]
        window = self._hb_timeout if window is None else window
        return tuple(sorted(
            w for w, t in self._seen.items() if now - t <= window))

    def _monitor(self) -> None:
        while not self._shutdown.is_set():
            alive = self._poll_members()
            hint = self._kv.get("/rendezvous/hint")
            if hint:
                self._kv.put("/rendezvous/hint", b"")
                # A survivor reported a peer dead: shrink the liveness
                # window to a few beat intervals so the dead peer is
                # retired NOW instead of after the full heartbeat timeout
                # (reference analog: driver.py:291 immediate exit handling).
                fast = self._poll_members(window=4 * HEARTBEAT_INTERVAL_S)
                stale = set(alive) - set(fast)
                if stale:
                    for w in stale:
                        self._seen.pop(w, None)
                    alive = fast
            if alive != self._members and len(alive) >= self.min_np:
                with self._lock:
                    self._members = alive
                    self._rendezvous(alive)
            time.sleep(self._interval)

    def _rendezvous(self, members: tuple) -> None:
        np_ = min(len(members), self.max_np)
        use = members[:np_]
        # host list in worker_id order; get_host_assignments needs
        # (host, slots) pairs — one slot per Spark task.
        by_host: Dict[str, int] = {}
        for w in use:
            h = self._hosts.get(w, w)
            by_host[h] = by_host.get(h, 0) + 1
        slots = get_host_assignments(sorted(by_host.items()), np_)
        self._epoch += 1
        epoch = self._epoch
        controller_host = slots[0].hostname
        controller_port = _free_port()
        # Map each member to a slot on its host, in stable order.
        remaining = {s.hostname: [] for s in slots}
        for s in slots:
            remaining[s.hostname].append(s)
        for w in use:
            h = self._hosts.get(w, w)
            s = remaining[h].pop(0)
            assignment = {
                "rank": s.rank, "size": s.size,
                "local_rank": s.local_rank, "local_size": s.local_size,
                "cross_rank": s.cross_rank, "cross_size": s.cross_size,
                "controller_addr": controller_host,
                "controller_port": controller_port,
                "epoch": epoch,
            }
            self._kv.put(f"/rendezvous/{epoch}/assignment/{w}",
                         json.dumps(assignment).encode())
        self._kv.put("/rendezvous/epoch", str(epoch).encode())
        self._kv.put("/rendezvous/updates", str(epoch).encode())
        log.info("spark elastic: rendezvous epoch %d with %d workers",
                 epoch, np_)


def heartbeat_loop(client, worker_id: str, hostname: str,
                   interval_s: float = HEARTBEAT_INTERVAL_S, stop=None):
    """Daemon-thread body for workers: keep the membership lease fresh.
    Each beat carries ``hostname|timestamp`` — the changing payload is what
    proves liveness (the KV store never expires keys). ``stop`` (an Event)
    ends the loop so reused pyspark worker processes don't keep beating
    after the task finished."""
    while stop is None or not stop.is_set():
        try:
            client.put(_ALIVE_PREFIX + worker_id,
                       f"{hostname}|{time.time():.3f}".encode())
        except Exception:
            pass  # driver mid-restart; the next beat retries
        time.sleep(interval_s)
