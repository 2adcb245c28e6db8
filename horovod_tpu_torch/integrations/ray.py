"""Ray integration, the counterpart of ``horovod_tpu/integrations/ray.py``
(reference: ``horovod/ray/runner.py`` — ``MiniSettings``
:17, ``BaseHorovodWorker`` :43, ``NodeColocator`` :84, ``Coordinator`` :169,
``RayExecutor`` :246 with ``create_settings`` :262, ``start`` :328,
``execute`` :395, ``run`` :406, ``execute_single`` :428).

Ray is optional and not bundled; everything here import-gates cleanly and
raises an actionable error when ray is missing. The ray module is resolved
lazily (at executor construction, not at import) so test harnesses can
provide a stand-in implementation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


def _ray():
    try:
        import ray
        return ray
    except ImportError:
        raise ImportError(
            "RayExecutor requires ray (`pip install ray`); for local "
            "multi-process execution without ray, use "
            "horovod_tpu_torch.integrations.Executor")


@dataclass
class MiniSettings:
    """Settings subset meaningful here (reference:
    MiniSettings, horovod/ray/runner.py:17 — ssh fields dropped: ray actors
    replace ssh exec, and the TCP controller replaces gloo rendezvous).
    ``timeout_s`` bounds actor startup/registration during ``start()``."""
    timeout_s: int = 300
    placement_group_timeout_s: int = 100
    extra_env: Dict[str, str] = field(default_factory=dict)


class _Coordinator:
    """Collects worker hostnames and assigns Horovod-style topology env
    (reference: Coordinator, horovod/ray/runner.py:169 — ``register`` /
    ``finalize_registration`` collapse to ``env_for`` because hostnames
    arrive as one list, not incremental registrations)."""

    def __init__(self, node_ids: List[str], controller_addr: str,
                 controller_port: int):
        self.node_ids = node_ids
        self.controller_addr = controller_addr
        self.controller_port = controller_port

    def env_for(self, rank: int) -> dict:
        from ..utils import envvars as ev
        node = self.node_ids[rank]
        local_peers = [i for i, h in enumerate(self.node_ids) if h == node]
        hosts = sorted(set(self.node_ids), key=self.node_ids.index)
        return {
            ev.HVDTPU_RANK: str(rank),
            ev.HVDTPU_SIZE: str(len(self.node_ids)),
            ev.HVDTPU_LOCAL_RANK: str(local_peers.index(rank)),
            ev.HVDTPU_LOCAL_SIZE: str(len(local_peers)),
            ev.HVDTPU_CROSS_RANK: str(hosts.index(node)),
            ev.HVDTPU_CROSS_SIZE: str(len(hosts)),
            ev.HVDTPU_CONTROLLER_ADDR: self.controller_addr,
            ev.HVDTPU_CONTROLLER_PORT: str(self.controller_port),
        }


def _make_worker_cls(ray):
    """Actor class shared by all placement modes (reference:
    BaseHorovodWorker, horovod/ray/runner.py:43)."""

    class _Worker:
        def __init__(self):
            self.executable = None

        def hostname(self):
            import socket
            return socket.gethostname()

        def probe_port(self):
            # Runs ON this worker's node — the controller binds there,
            # so the free-port probe must happen there too.
            import socket
            s = socket.socket()
            s.bind(("", 0))
            port = s.getsockname()[1]
            s.close()
            return port

        def set_env(self, env):
            import os
            os.environ.update(env)

        def start_executable(self, executable_cls, args, kwargs):
            if executable_cls is not None:
                self.executable = executable_cls(*(args or ()),
                                                 **(kwargs or {}))

        def execute(self, fn):
            return fn(self.executable)

        def execute_args(self, fn, args, kwargs):
            return fn(*(args or ()), **(kwargs or {}))

    return _Worker


class RayExecutor:
    """Reference API (horovod/ray/runner.py:246): construct with either a
    flat ``num_workers`` or a ``num_hosts × num_slots`` topology, then
    ``start() → run(fn)/execute(fn) → shutdown()`` with one Ray actor per
    worker slot."""

    @classmethod
    def create_settings(cls, timeout_s: int = 300,
                        placement_group_timeout_s: int = 100,
                        **kwargs) -> MiniSettings:
        """Reference: create_settings, horovod/ray/runner.py:262.
        Reference-only kwargs (ssh_identity_file, ssh_str, nics, ...) are
        accepted and ignored — actors replace ssh, and the controller
        preflight replaces NIC selection."""
        known = {k: v for k, v in kwargs.items()
                 if k in MiniSettings.__dataclass_fields__}
        return MiniSettings(
            timeout_s=timeout_s,
            placement_group_timeout_s=placement_group_timeout_s, **known)

    def __init__(self, settings: Optional[MiniSettings] = None,
                 num_workers: Optional[int] = None,
                 num_hosts: Optional[int] = None,
                 num_slots: Optional[int] = None,
                 cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 gpus_per_worker: Optional[int] = None,
                 resources_per_worker: Optional[dict] = None,
                 device=None):
        self.ray = _ray()
        if num_workers is not None and num_hosts is not None:
            raise ValueError("pass either num_workers or "
                             "num_hosts/num_slots, not both")
        if num_slots is not None and num_hosts is None:
            raise ValueError("num_slots requires num_hosts (slots are "
                             "per-host); for a flat count use num_workers")
        if num_workers is None and num_hosts is None:
            num_workers = 2
        self.settings = settings or MiniSettings()
        self.num_hosts = num_hosts
        self.num_slots = num_slots or 1
        self._num_workers = (num_workers if num_workers is not None
                             else num_hosts * self.num_slots)
        self.cpus_per_worker = cpus_per_worker
        self.use_gpu = use_gpu
        self.gpus_per_worker = gpus_per_worker or (1 if use_gpu else 0)
        self.resources_per_worker = resources_per_worker or {}
        # Where each worker's runtime runs: by default the card of its
        # local rank; "cpu" on the CPU.
        self.device = device
        self._workers = []
        self._pg = None

    @property
    def num_workers(self) -> int:
        return self._num_workers

    @property
    def workers(self) -> List[Any]:
        return self._workers

    def _placement_options(self) -> List[dict]:
        """Per-worker ray.remote options. With ``num_hosts``/``num_slots``
        the reference colocates slots per machine (NodeColocator,
        horovod/ray/runner.py:84); here a STRICT_SPREAD placement group of
        per-host bundles does the same without a colocator actor layer."""
        ray = self.ray
        base = dict(num_cpus=self.cpus_per_worker,
                    num_gpus=self.gpus_per_worker,
                    resources=self.resources_per_worker or None)
        if self.num_hosts is None:
            return [dict(base) for _ in range(self._num_workers)]
        try:
            from ray.util.placement_group import placement_group
            bundles = [{"CPU": self.cpus_per_worker * self.num_slots,
                        "GPU": self.gpus_per_worker * self.num_slots}
                       for _ in range(self.num_hosts)]
            bundles = [{k: v for k, v in b.items() if v} for b in bundles]
            self._pg = placement_group(bundles, strategy="STRICT_SPREAD")
            ray.get(self._pg.ready(),
                    timeout=self.settings.placement_group_timeout_s)
            # Modern Ray (2.x) rejects the raw placement_group/
            # placement_group_bundle_index options in favor of
            # scheduling_strategy=PlacementGroupSchedulingStrategy; keep the
            # legacy options only for rays that predate it.
            try:
                from ray.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy)
            except ImportError:
                PlacementGroupSchedulingStrategy = None
            opts = []
            for host in range(self.num_hosts):
                for _ in range(self.num_slots):
                    o = dict(base)
                    if PlacementGroupSchedulingStrategy is not None:
                        o["scheduling_strategy"] = \
                            PlacementGroupSchedulingStrategy(
                                placement_group=self._pg,
                                placement_group_bundle_index=host)
                    else:
                        o["placement_group"] = self._pg
                        o["placement_group_bundle_index"] = host
                    opts.append(o)
            return opts
        except ImportError:
            # Stand-in / old ray without placement groups: plain spread.
            return [dict(base) for _ in range(self._num_workers)]

    def start(self, executable_cls: Optional[type] = None,
              executable_args: Optional[list] = None,
              executable_kwargs: Optional[dict] = None,
              extra_env_vars: Optional[Dict[str, str]] = None) -> None:
        """Reference: start, horovod/ray/runner.py:328 — spawn actors,
        collect hostnames, assign topology env (+ ``extra_env_vars``), and
        instantiate ``executable_cls`` on every worker."""
        ray = self.ray
        if not ray.is_initialized():
            ray.init()
        worker_cls = _make_worker_cls(ray)
        self._workers = [
            ray.remote(**{k: v for k, v in opts.items() if v is not None})(
                worker_cls).remote()
            for opts in self._placement_options()]
        node_ids = ray.get([w.hostname.remote() for w in self._workers],
                           timeout=self.settings.timeout_s)
        # Rank 0 hosts the controller; probe the port on its node.
        port = ray.get(self._workers[0].probe_port.remote(),
                       timeout=self.settings.timeout_s)
        coord = _Coordinator(node_ids, node_ids[0], port)
        env_vars = dict(self.settings.extra_env)
        env_vars.update(extra_env_vars or {})
        ray.get([w.set_env.remote({**coord.env_for(i), **env_vars})
                 for i, w in enumerate(self._workers)])
        ray.get([w.start_executable.remote(executable_cls, executable_args,
                                           executable_kwargs)
                 for w in self._workers])

    def _under_runtime(self, fn: Callable) -> Callable:
        device = self.device

        def wrapped(*a, **k):
            from horovod_tpu_torch import runtime as hvd
            hvd.init(mode="process", device=device)
            try:
                return fn(*a, **k)
            finally:
                hvd.shutdown()
        return wrapped

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` on every worker under an initialized
        runtime; per-rank results ordered by rank (reference: run,
        horovod/ray/runner.py:406)."""
        return self.ray.get([
            w.execute_args.remote(self._under_runtime(fn), args, kwargs)
            for w in self._workers])

    def run_remote(self, fn: Callable, args: tuple = (),
                   kwargs: Optional[dict] = None) -> List[Any]:
        """Like ``run`` (fn executes under an initialized runtime) but
        returns the per-worker object refs without blocking, for composing
        with ``ray.wait``."""
        return [w.execute_args.remote(self._under_runtime(fn), args, kwargs)
                for w in self._workers]

    def execute(self, fn: Callable[[Any], Any]) -> List[Any]:
        """Run ``fn(executable)`` on every worker (reference: execute,
        horovod/ray/runner.py:395)."""
        return self.ray.get([w.execute.remote(fn) for w in self._workers])

    def execute_single(self, fn: Callable[[Any], Any]) -> Any:
        """Run ``fn(executable)`` on the rank-0 (chief) worker only
        (reference: execute_single, horovod/ray/runner.py:428)."""
        return self.ray.get(self._workers[0].execute.remote(fn))

    def shutdown(self) -> None:
        for w in self._workers:
            try:
                self.ray.kill(w)
            except Exception:
                pass
        self._workers = []
        if self._pg is not None:
            try:
                from ray.util.placement_group import remove_placement_group
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
