"""Priority-ordered collective backend registry.

Counterpart of ``horovod_tpu/ops/dispatch.py`` (``DispatchContext`` :30,
``CollectiveBackend`` :37, ``register_backend`` :55,
``unregister_backend`` :65, ``resolve`` :80); reference:
``horovod/common/ops/operation_manager.{h,cc}``, an ordered list of
implementations per collective whose first enabled one runs.

The port's built-ins, in :mod:`horovod_tpu_torch.ops.collectives`:

* ``native_process`` (priority 200): the native core, enabled in process
  mode (``init(mode="process")``);
* ``torch_distributed`` (priority 100): the ``torch.distributed`` process
  groups (NCCL on the card, gloo on the CPU), enabled otherwise.

The public collectives resolve their backend here, and so do the launches
the optimizer and the compressed reducers use (``launch_reduce``). The
registry is internal, as in the JAX package, which does not export it
either: a backend registered above or below the built-ins (a logging
wrapper, an experimental fabric) implements ``enabled`` and any of the
operations, and one it lacks falls through to the next enabled backend.
The JAX package's third built-in, its in-step XLA backend, has no
counterpart: the port's in-step operators
(:mod:`horovod_tpu_torch.ops.spmd`) are functions of their own.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """What a backend is selected against."""
    mode: str          # runtime mode: "spmd" | "process"
    axis: Optional[object]


class CollectiveBackend:
    """Base backend. Subclasses implement ``enabled`` and any of the
    operations (``allreduce``, ``grouped_allreduce``, ``allgather``,
    ``broadcast``, ``broadcast_``, ``alltoall``, ``reducescatter``, their
    ``*_async`` forms, ``join`` and ``launch_reduce``); a missing one falls
    through to the next enabled backend."""

    name: str = "backend"
    priority: int = 0

    def enabled(self, ctx: DispatchContext) -> bool:
        raise NotImplementedError


# Replaced whole under the lock, never changed in place, so that
# ``resolve`` reads it without taking the lock.
_lock = threading.Lock()
_registry: Tuple[CollectiveBackend, ...] = ()


def register_backend(backend: CollectiveBackend) -> None:
    """Insert a backend by priority (highest first; stable among
    equals)."""
    global _registry
    with _lock:
        if any(b.name == backend.name for b in _registry):
            raise ValueError(f"backend {backend.name!r} already registered")
        _registry = tuple(sorted(_registry + (backend,),
                                 key=lambda b: -b.priority))


def unregister_backend(name: str) -> None:
    global _registry
    with _lock:
        kept = tuple(b for b in _registry if b.name != name)
        if len(kept) == len(_registry):
            raise KeyError(name)
        _registry = kept


def backends() -> List[CollectiveBackend]:
    """Registered backends in dispatch order."""
    return list(_registry)


def resolve(op: str, ctx: DispatchContext) -> CollectiveBackend:
    """The first enabled backend that implements ``op``."""
    for b in _registry:
        if hasattr(b, op) and b.enabled(ctx):
            return b
    raise RuntimeError(
        f"no enabled collective backend implements {op!r} for {ctx}")
