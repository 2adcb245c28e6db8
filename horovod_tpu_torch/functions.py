"""Object collectives: broadcast and allgather picklable Python objects.

Counterpart of ``horovod_tpu/functions.py`` (``broadcast_object`` :31,
``allgather_object`` :52); reference: ``horovod/torch/functions.py``
(:186, :229). An object is pickled into a uint8 tensor on the runtime's
device; the sizes are exchanged first, then the payloads, over the port's
own broadcast and uneven allgather, over every rank whatever the mesh
(the JAX package's process mode exchanges objects between all processes).
In process mode they run through the native core as the JAX package's do
(names ``broadcast_object``/``allgather_object`` and ``{name}.sz``; the
allgather's two gathers in one grouped window), on host tensors.
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional

import torch

from . import runtime
from .ops import collectives as C


def _serialize(obj: Any) -> torch.Tensor:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        runtime.device())


def _deserialize(payload: torch.Tensor) -> Any:
    return pickle.loads(payload.cpu().numpy().tobytes())


def _broadcast_object_process(obj, root_rank: int, name: str) -> Any:
    payload = _serialize(obj).cpu() if runtime.rank() == root_rank else \
        torch.zeros(0, dtype=torch.uint8)
    size = C.broadcast(torch.tensor([payload.numel()], dtype=torch.int64),
                       root_rank, name=f"{name}.sz")
    if runtime.rank() != root_rank:
        payload = torch.zeros(int(size[0]), dtype=torch.uint8)
    return _deserialize(C.broadcast(payload, root_rank, name=name))


def _allgather_object_process(obj, name: str) -> List[Any]:
    payload = _serialize(obj).cpu()
    with C.grouped_enqueue():
        h_pay = C.allgather_async(payload, name=name)
        h_sz = C.allgather_async(torch.tensor([payload.numel()],
                                              dtype=torch.int64),
                                 name=f"{name}.sz")
    gathered = C.synchronize(h_pay)
    sizes = C.synchronize(h_sz).tolist()
    return [_deserialize(part) for part in gathered.split(sizes)]


def broadcast_object(obj: Any = None, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """``root_rank``'s object, on every rank (reference:
    ``horovod/torch/functions.py:186``)."""
    if runtime.mode() == "process":
        if runtime.size() == 1:
            return obj
        return _broadcast_object_process(obj, root_rank,
                                         name or "broadcast_object")
    dev = runtime.device()
    if runtime.rank() == root_rank:
        payload = _serialize(obj)
        size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    world = runtime.axis_names()
    size = int(C.broadcast(size, root_rank, name=name and f"{name}.size",
                           axis=world))
    if runtime.rank() != root_rank:
        payload = torch.empty(size, dtype=torch.uint8, device=dev)
    return _deserialize(C.broadcast(payload, root_rank, name=name,
                                    axis=world))


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """Every rank's object, in rank order (reference:
    ``horovod/torch/functions.py:229``)."""
    if runtime.mode() == "process":
        if runtime.size() == 1:
            return [obj]
        return _allgather_object_process(obj, name or "allgather_object")
    payload = _serialize(obj)
    world = runtime.axis_names()
    sizes = C.allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                     device=payload.device),
                        name=name and f"{name}.size", axis=world).tolist()
    gathered = C.allgather(payload, name=name, axis=world)
    return [_deserialize(part) for part in gathered.split(sizes)]
