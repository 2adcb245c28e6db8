"""Topology runtime: ``init`` / ``rank`` / ``size`` / ``device``.

Counterpart of ``horovod_tpu/runtime.py`` (``init`` :308, ``shutdown`` :516,
topology getters :553-606, ``is_homogeneous`` :579) and of the build flags
of ``horovod_tpu/__init__.py:94-130``, answered for this package; reference
surface ``horovod/common/basics.py:22``.

One process drives one GPU, as in the reference Horovod and the JAX
package's process mode. Rank and size come from the ``HVDTPU_*`` variables
the ``hvdrun`` launcher exports, else from torchrun's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK``; without either the world is this one process. ``init``
always creates a real ``torch.distributed`` process group — NCCL on CUDA,
gloo on the CPU — even for a world of one, so the collective code that a
multi-GPU job runs is the code that runs on a single card.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Union

import torch
import torch.distributed as dist

from .exceptions import NotInitializedError
from .utils import envvars as ev
from .utils import logging as log


@dataclasses.dataclass
class _RuntimeState:
    initialized: bool = False
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    homogeneous: bool = True
    device: Optional[torch.device] = None


_state = _RuntimeState()
_lock = threading.RLock()


def _env_int(hvd_name: str, torch_name: Optional[str], default: int) -> int:
    v = ev.get_int(hvd_name, None)
    if v is None and torch_name is not None:
        v = ev.get_int(torch_name, None)
    return default if v is None else v


def _rendezvous(rank: int, size: int):
    """A ``TCPStore`` for the process group. A world of one binds an
    ephemeral port on the loopback (no race with other jobs); a larger
    world meets at the address the launcher exported."""
    if size == 1:
        return dist.TCPStore("127.0.0.1", 0, 1, True)
    addr = ev.get_str(ev.HVDTPU_CONTROLLER_ADDR) or \
        ev.get_str(ev.MASTER_ADDR, "127.0.0.1")
    port = ev.get_int(ev.HVDTPU_CONTROLLER_PORT, None)
    if port is None:
        port = ev.get_int(ev.MASTER_PORT, None)
    if port is None:
        raise ValueError(
            f"a world of {size} ranks needs a rendezvous port: set "
            f"{ev.HVDTPU_CONTROLLER_PORT} (hvdrun) or {ev.MASTER_PORT} "
            "(torchrun)")
    return dist.TCPStore(addr, port, size, rank == 0)


def init(device: Union[str, torch.device, None] = None) -> None:
    """Initialize the runtime (reference: ``hvd.init()``,
    ``horovod/common/basics.py:34``). A second call is a no-op.

    Args:
      device: where this rank computes. ``None`` picks ``cuda:{local_rank}``
        and raises when CUDA is absent; pass ``device="cpu"`` to run on the
        CPU (gloo), as the tests do.
    """
    global _state
    with _lock:
        if _state.initialized:
            return
        st = _RuntimeState()
        st.rank = _env_int(ev.HVDTPU_RANK, ev.RANK, 0)
        st.size = _env_int(ev.HVDTPU_SIZE, ev.WORLD_SIZE, 1)
        st.local_rank = _env_int(ev.HVDTPU_LOCAL_RANK, ev.LOCAL_RANK, 0)
        st.local_size = _env_int(ev.HVDTPU_LOCAL_SIZE, ev.LOCAL_WORLD_SIZE,
                                 1)
        st.cross_rank = _env_int(ev.HVDTPU_CROSS_RANK, None, st.rank)
        st.cross_size = _env_int(ev.HVDTPU_CROSS_SIZE, None, st.size)
        if not 0 <= st.rank < st.size:
            raise ValueError(f"rank {st.rank} is outside a world of "
                             f"{st.size}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init() runs on a CUDA device by "
                    "default, and CUDA is not available here; pass "
                    "device=\"cpu\" to run on the CPU")
            device = torch.device("cuda", st.local_rank)
        st.device = torch.device(device)
        if st.device.type == "cuda":
            torch.cuda.set_device(st.device)
            backend = "nccl"
        elif st.device.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"unsupported device {st.device}; use a CUDA "
                             "device or \"cpu\"")
        store = _rendezvous(st.rank, st.size)
        dist.init_process_group(backend, store=store, rank=st.rank,
                                world_size=st.size)
        # Every node runs as many ranks when every rank's local_size agrees.
        local = torch.tensor([st.local_size], dtype=torch.int64,
                             device=st.device)
        sizes = torch.empty(st.size, dtype=torch.int64, device=st.device)
        dist.all_gather_into_tensor(sizes, local)
        st.homogeneous = bool((sizes == st.local_size).all())
        log.debug("init: rank %d/%d on %s (%s)", st.rank, st.size,
                  st.device, backend)
        st.initialized = True
        _state = st


def shutdown() -> None:
    """Tear down the runtime (reference: ``horovod_shutdown``,
    operations.cc:718)."""
    global _state
    with _lock:
        if not _state.initialized:
            return
        dist.destroy_process_group()
        _state = _RuntimeState()


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _RuntimeState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    return _require_init().local_rank


def local_size() -> int:
    return _require_init().local_size


def cross_rank() -> int:
    return _require_init().cross_rank


def cross_size() -> int:
    return _require_init().cross_size


def is_homogeneous() -> bool:
    """True when every node runs the same number of ranks (reference:
    ``horovod_is_homogeneous``); exchanged once, at ``init``."""
    return _require_init().homogeneous


def device() -> torch.device:
    """The device ``init`` chose for this rank."""
    return _require_init().device


# Build flags (reference: ``horovod/common/basics.py``), for this package:
# torch.distributed's NCCL and gloo, no MPI, DDL, oneCCL or ROCm.

def cuda_built() -> bool:
    """CUDA is compiled into this torch."""
    return torch.backends.cuda.is_built()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    """The process group runs on gloo (``init(device="cpu")``)."""
    return _state.initialized and dist.get_backend() == "gloo"


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False
