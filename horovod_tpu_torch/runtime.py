"""Topology runtime: ``init`` / ``rank`` / ``size`` / ``device`` / ``mesh``.

Counterpart of ``horovod_tpu/runtime.py`` (``_build_mesh`` :276, ``init``
:308, ``shutdown`` :516, topology getters :553-611, ``is_homogeneous``
:579) and of the build flags
of ``horovod_tpu/__init__.py:94-130``, answered for this package; reference
surface ``horovod/common/basics.py:22``.

One process drives one GPU, as in the reference Horovod and the JAX
package's process mode. Rank and size come from the ``HVDTPU_*`` variables
the ``hvdrun`` launcher exports, else from torchrun's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK``; without either the world is this one process. ``init``
always creates a real ``torch.distributed`` process group — NCCL on CUDA,
gloo on the CPU — even for a world of one, so the collective code that a
multi-GPU job runs is the code that runs on a single card.

The ranks form a device mesh with named axes (``init(mesh_shape=...)``,
default ``{"dp": size}``), laid out as the JAX package lays out its
devices: row-major over the axes in the order given, so on a
``{"dcn": D, "ici": I}`` mesh rank ``o * I + i`` sits at ``(o, i)``. Every
axis, and every set of axes, has its process group (:func:`group`): the
ranks that share their coordinates on the other axes. The collectives take
an ``axis=`` and run over that group; without one they run over every rank.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

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
    mesh: object = None  # torch.distributed.device_mesh.DeviceMesh
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    axis_names: Tuple[str, ...] = ()
    dp_axis: str = ""
    # A tuple of axis names, in mesh order -> its process group.
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)


DP_AXIS = "dp"
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


def _mesh_dims(mesh_shape, axis_names: Sequence[str], size: int
               ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Axis names and sizes of the mesh (JAX ``_build_mesh``,
    ``horovod_tpu/runtime.py:276-305``): a dict, or a tuple of sizes named
    by ``axis_names``; else ``HVDTPU_MESH_SHAPE`` ("dp=4,tp=2"); else one
    ``dp`` axis over every rank. Their product must be the world size."""
    if mesh_shape is None:
        spec = ev.get_str(ev.HVDTPU_MESH_SHAPE)
        if spec:
            mesh_shape = {}
            for part in spec.split(","):
                k, v = part.split("=")
                mesh_shape[k.strip()] = int(v)
        else:
            mesh_shape = {DP_AXIS: size}
    if isinstance(mesh_shape, dict):
        names = tuple(mesh_shape)
        dims = tuple(int(d) for d in mesh_shape.values())
    else:
        dims = tuple(int(d) for d in mesh_shape)
        names = tuple(axis_names)
    if len(names) != len(dims) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} do not name the dims {dims} "
                         "once each")
    total = math.prod(dims)
    if total != size:
        raise ValueError(f"mesh_shape {dims} (={total} ranks) does not "
                         f"match the world of {size} ranks")
    return names, dims


def _build_groups(st: _RuntimeState) -> None:
    """The ``DeviceMesh`` and a process group for every set of its axes:
    one axis's group is the mesh's own; a larger set's joins the ranks that
    share their coordinates on the other axes (every rank creates every
    block's group, in the same order); all axes together are the world."""
    names, dims = st.axis_names, tuple(st.mesh_shape.values())
    st.mesh = init_device_mesh(st.device.type, dims, mesh_dim_names=names)
    layout = torch.arange(st.size).view(dims)
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), k):
            key = tuple(names[a] for a in axes)
            if k == len(names):
                st.groups[key] = dist.group.WORLD
                continue
            if k == 1:
                st.groups[key] = st.mesh.get_group(key[0])
                continue
            rest = [a for a in range(len(names)) if a not in axes]
            blocks = layout.permute(*rest, *axes).reshape(
                -1, math.prod(dims[a] for a in axes)).tolist()
            for block in blocks:
                g = dist.new_group(block)
                if st.rank in block:
                    st.groups[key] = g


def init(device: Union[str, torch.device, None] = None, mesh_shape=None,
         axis_names: Sequence[str] = (DP_AXIS,), dp_axis: str = DP_AXIS
         ) -> None:
    """Initialize the runtime (reference: ``hvd.init()``,
    ``horovod/common/basics.py:34``; JAX ``init``,
    ``horovod_tpu/runtime.py:308``). A second call is a no-op.

    Args:
      device: where this rank computes. ``None`` picks ``cuda:{local_rank}``
        and raises when CUDA is absent; pass ``device="cpu"`` to run on the
        CPU (gloo), as the tests do.
      mesh_shape: the device mesh, a dict ``{"dcn": 2, "ici": 4}`` or a
        tuple of sizes named by ``axis_names``; default
        ``HVDTPU_MESH_SHAPE``, else ``{"dp": size}``. Row-major: rank
        ``o * n_inner + i`` sits at ``(o, i)``.
      axis_names: names of a tuple ``mesh_shape``'s dims.
      dp_axis: the data-parallel axis (the first axis when the mesh has no
        axis of that name).
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
        names, dims = _mesh_dims(mesh_shape, axis_names, st.size)
        st.axis_names = names
        st.mesh_shape = dict(zip(names, dims))
        st.dp_axis = dp_axis if dp_axis in names else names[0]
        store = _rendezvous(st.rank, st.size)
        dist.init_process_group(backend, store=store, rank=st.rank,
                                world_size=st.size)
        _build_groups(st)
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
    """Tear down the runtime and every process group of the mesh
    (reference: ``horovod_shutdown``, operations.cc:718)."""
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


def mesh():
    """The ranks' :class:`torch.distributed.device_mesh.DeviceMesh`."""
    return _require_init().mesh


def mesh_shape() -> Dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    return dict(_require_init().mesh_shape)


def dp_axis() -> str:
    """Name of the data-parallel mesh axis."""
    return _require_init().dp_axis


def axis_names() -> Tuple[str, ...]:
    return _require_init().axis_names


def group(axis=None):
    """The process group of a mesh axis (a name), of several axes (a tuple
    of names in any order: the ranks that share their coordinates on the
    other axes), or of every rank (``None``)."""
    st = _require_init()
    if axis is None:
        return dist.group.WORLD
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    unknown = [a for a in names if a not in st.axis_names]
    if unknown or not names or len(set(names)) != len(names):
        raise ValueError(f"axis {axis!r} does not name axes of the mesh "
                         f"{st.mesh_shape} once each")
    return st.groups[tuple(a for a in st.axis_names if a in names)]


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
