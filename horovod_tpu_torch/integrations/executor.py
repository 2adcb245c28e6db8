"""Programmatic executor over the port's runner.

Counterpart of ``horovod_tpu/integrations/executor.py``.

Reference shape: ``horovod.ray.RayExecutor`` (``horovod/ray/runner.py:246``:
``start() / run(fn) / execute(fn) / shutdown()``) and ``horovod.spark.run``
(``horovod/spark/runner.py:195``) — both place N workers, rendezvous them,
run a pickled fn, and return per-rank results. Here the workers are
processes started by ``hvd.run`` (:func:`horovod_tpu_torch.runner.run`)
under the port's native core.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class Executor:
    """Run functions on a persistent-configuration worker group.

    Unlike :func:`horovod_tpu_torch.runner.run` (one-shot), this mirrors the
    RayExecutor lifecycle: configure once, ``run`` many functions.
    ``launcher_kwargs`` go to ``run`` (``device="cpu"`` among them).
    """

    def __init__(self, num_workers: int = 2, hosts: Optional[str] = None,
                 verbose: bool = False, **launcher_kwargs):
        self.num_workers = num_workers
        self.hosts = hosts
        self.verbose = verbose
        self.launcher_kwargs = launcher_kwargs
        self._started = False

    def start(self) -> None:
        """Validate the configuration (reference: RayExecutor.start creates
        placement groups; the runner spawns per ``run`` call)."""
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self._started = True

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        """Execute ``fn(*args, **kwargs)`` on every worker under an
        initialized runtime; returns per-rank results ordered by rank
        (reference: ``RayExecutor.run``, horovod/ray/runner.py:406)."""
        if not self._started:
            self.start()
        from .. import runner
        return runner.run(fn, args=args, kwargs=kwargs, np=self.num_workers,
                          hosts=self.hosts, verbose=self.verbose,
                          **self.launcher_kwargs)

    # Reference alias: execute == run-on-all (horovod/ray/runner.py).
    execute = run

    def shutdown(self) -> None:
        self._started = False
