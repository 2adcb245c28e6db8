"""Object collectives: broadcast and allgather picklable Python objects.

Counterpart of ``horovod_tpu/functions.py`` (``broadcast_object`` :31,
``allgather_object`` :52); reference: ``horovod/torch/functions.py``
(:186, :229). An object is pickled into a uint8 tensor on the runtime's
device; the sizes are exchanged first, then the payloads, over the port's
own broadcast and uneven allgather.
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


def broadcast_object(obj: Any = None, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """``root_rank``'s object, on every rank (reference:
    ``horovod/torch/functions.py:186``)."""
    dev = runtime.device()
    if runtime.rank() == root_rank:
        payload = _serialize(obj)
        size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    size = int(C.broadcast(size, root_rank, name=name and f"{name}.size"))
    if runtime.rank() != root_rank:
        payload = torch.empty(size, dtype=torch.uint8, device=dev)
    return _deserialize(C.broadcast(payload, root_rank, name=name))


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """Every rank's object, in rank order (reference:
    ``horovod/torch/functions.py:229``)."""
    payload = _serialize(obj)
    sizes = C.allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                     device=payload.device),
                        name=name and f"{name}.size").tolist()
    gathered = C.allgather(payload, name=name)
    return [_deserialize(part) for part in gathered.split(sizes)]
