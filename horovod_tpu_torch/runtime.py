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
an ``axis=`` and run over that group; without one they run over the
data-parallel axis (:func:`dp_axis`), as the JAX package's ``axis=None``
does. An exchange that must span every rank asks for :func:`world_group`.

``init(mode="process")`` is the JAX package's process mode
(``horovod_tpu/runtime.py:355-500``): no ``torch.distributed`` group is
created; each rank starts the native core (:mod:`horovod_tpu_torch.basics`),
whose background thread negotiates every named collective with rank 0's
controller, fuses them and moves their bytes over TCP or shared memory.
The ranks meet at ``HVDTPU_CONTROLLER_ADDR``:``HVDTPU_CONTROLLER_PORT``.
The mesh is one ``dp`` axis over every rank; tensors on the card are staged
through pinned host memory (:mod:`horovod_tpu_torch.ops.collectives`).

Under the elastic driver (``hvdrun-torch --host-discovery-script``, which
exports ``HVDTPU_RENDEZVOUS_ADDR`` and no ``HVDTPU_SIZE``), ``init()``
takes process mode, as the JAX package's ``_detect_mode`` does
(``horovod_tpu/runtime.py:139-142``), and reads this worker's rank, size
and controller from the driver's rendezvous (:func:`_elastic_assignment`);
``mode="spmd"`` there raises. :func:`reinit` starts the runtime again with
the last ``init``'s arguments, as ``hvd.elastic.run`` does after a reset.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import sys
import threading
import time
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
    mode: str = "spmd"
    core: object = None  # basics.NativeCore in process mode
    # Grows by one at every init: what was built against one world (an
    # optimizer's layout check) can tell that the world was made anew.
    epoch: int = 0


DP_AXIS = "dp"
_state = _RuntimeState()
_lock = threading.RLock()
# The arguments of the last init, for reinit.
_init_kwargs: dict = {}

# The last rendezvous epoch this process initialized with (elastic): a new
# init takes only a newer one, so a worker never joins the world that just
# failed.
_elastic_last_epoch = 0
# When the elastic retry loop saw a peer fail (time.monotonic()); the next
# init records the time from it to the world's re-formation in the new
# core (hvdtpu_recovery_seconds).
_failure_detected_at: Optional[float] = None


def note_failure_detected() -> None:
    """Mark the moment a peer failure was seen (JAX ``runtime.py:156``);
    the first mark of an outage counts until an init succeeds."""
    global _failure_detected_at
    if _failure_detected_at is None:
        _failure_detected_at = time.monotonic()


def _elastic_assignment() -> Optional[dict]:
    """This worker's assignment from the elastic driver's store (JAX
    ``runtime.py:165-223``; keys in
    :mod:`horovod_tpu_torch.runner.elastic.driver`), or None outside an
    elastic job: wait for an epoch newer than the last one this process
    took, read the assignment of ``HVDTPU_WORKER_ID`` in it and claim it
    (``/rendezvous/{epoch}/ready/{id}``, which the driver's settle
    watchdog waits for). A worker that a newer epoch leaves out for 5 s
    was scaled away and exits with code 0. TimeoutError after
    ``HVDTPU_ELASTIC_TIMEOUT`` seconds."""
    global _elastic_last_epoch
    addr = ev.get_str(ev.HVDTPU_RENDEZVOUS_ADDR)
    if not addr:
        return None
    from .runner.http_kv import KVStoreClient
    worker_id = ev.get_str(ev.HVDTPU_WORKER_ID)
    client = KVStoreClient(addr, ev.get_int(ev.HVDTPU_RENDEZVOUS_PORT, 0),
                           secret=ev.get_str(ev.HVDTPU_SECRET))
    deadline = time.monotonic() + ev.get_float(ev.HVDTPU_ELASTIC_TIMEOUT,
                                               600.0)
    missing_since = None
    while time.monotonic() < deadline:
        try:
            raw = client.get("/rendezvous/epoch")
        except OSError:
            # The driver's store is briefly unreachable: a worker that
            # exited now would get its healthy host blacklisted.
            raw = None
        epoch = int(raw) if raw else 0
        if epoch > _elastic_last_epoch:
            try:
                assignment = client.get(
                    f"/rendezvous/{epoch}/assignment/{worker_id}")
            except OSError:
                assignment = None
            if assignment:
                _elastic_last_epoch = epoch
                try:
                    client.put(f"/rendezvous/{epoch}/ready/{worker_id}",
                               b"1")
                except OSError:
                    pass  # the claim is advisory: the watchdog respawns us
                return json.loads(assignment)
            if missing_since is None:
                missing_since = time.monotonic()
            elif time.monotonic() - missing_since > 5.0:
                log.info("elastic: worker %s removed from epoch %d; "
                         "exiting cleanly", worker_id, epoch)
                sys.exit(0)
        time.sleep(0.25)
    raise TimeoutError("elastic rendezvous timed out")


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


def _start_core(st: _RuntimeState, controller=(None, None)) -> None:
    """Create and start this rank's native core, whose controller is at
    ``controller`` (address, port; None: the ``HVDTPU_CONTROLLER_*``
    variables); a core that cannot be built or loaded raises, as does a
    failed form-up, after the half-joined core is shut down. A start that
    follows a detected failure records the time the recovery took."""
    global _failure_detected_at
    from . import basics
    try:
        st.core = basics.NativeCore(
            rank=st.rank, size=st.size, local_rank=st.local_rank,
            local_size=st.local_size, cross_rank=st.cross_rank,
            cross_size=st.cross_size, coord_host=controller[0],
            coord_port=controller[1])
    except (OSError, RuntimeError) as exc:
        raise NotInitializedError(
            "process mode: the native core (horovod_tpu_torch/native, "
            f"built with g++) could not be built or loaded: {exc}") from exc
    try:
        st.core.start()
    except Exception:
        st.core.shutdown()
        raise
    if _failure_detected_at is not None:
        st.core.observe_recovery(time.monotonic() - _failure_detected_at)
        _failure_detected_at = None


def init(device: Union[str, torch.device, None] = None, mesh_shape=None,
         axis_names: Sequence[str] = (DP_AXIS,), dp_axis: str = DP_AXIS,
         mode: Optional[str] = None) -> None:
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
      mode: ``None`` or ``"spmd"``, the ``torch.distributed`` world above;
        ``"process"``, the native core's world (no process group; the mesh
        is ``{"dp": size}`` and any other ``mesh_shape`` raises). ``None``
        under the elastic driver is ``"process"``, and ``"spmd"`` there
        raises.
    """
    global _state, _init_kwargs
    with _lock:
        if _state.initialized:
            return
        elastic = bool(ev.get_str(ev.HVDTPU_RENDEZVOUS_ADDR))
        if mode is None:
            mode = "process" if elastic else "spmd"
        if mode not in ("spmd", "process"):
            raise ValueError(f"mode must be \"spmd\" or \"process\", got "
                             f"{mode!r}")
        if elastic and mode != "process":
            raise ValueError(
                "an elastic worker (HVDTPU_RENDEZVOUS_ADDR is set) runs in "
                "process mode, whose native core re-forms the world at each "
                "rendezvous; call init() or init(mode=\"process\")")
        _init_kwargs = dict(device=device, mesh_shape=mesh_shape,
                            axis_names=axis_names, dp_axis=dp_axis,
                            mode=mode)
        st = _RuntimeState(mode=mode, epoch=_state.epoch + 1)
        assignment = _elastic_assignment() if elastic else None
        if assignment is not None:
            for key in ("rank", "size", "local_rank", "local_size",
                        "cross_rank", "cross_size"):
                setattr(st, key, assignment[key])
            controller = (assignment["controller_addr"],
                          assignment["controller_port"])
        else:
            st.rank = _env_int(ev.HVDTPU_RANK, ev.RANK, 0)
            st.size = _env_int(ev.HVDTPU_SIZE, ev.WORLD_SIZE, 1)
            st.local_rank = _env_int(ev.HVDTPU_LOCAL_RANK, ev.LOCAL_RANK, 0)
            st.local_size = _env_int(ev.HVDTPU_LOCAL_SIZE,
                                     ev.LOCAL_WORLD_SIZE, 1)
            st.cross_rank = _env_int(ev.HVDTPU_CROSS_RANK, None, st.rank)
            st.cross_size = _env_int(ev.HVDTPU_CROSS_SIZE, None, st.size)
            controller = (None, None)
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
        if mode == "process":
            if mesh_shape is not None and dict(mesh_shape) != {
                    DP_AXIS: st.size}:
                raise ValueError(
                    f"process mode runs one \"dp\" axis over every rank, "
                    f"{{\"dp\": {st.size}}}; got mesh_shape {mesh_shape!r}")
            st.axis_names = (DP_AXIS,)
            st.mesh_shape = {DP_AXIS: st.size}
            st.dp_axis = DP_AXIS
            _start_core(st, controller)
            sizes = st.core.collective(
                "allgather", "hvd.init.local_size",
                torch.tensor([st.local_size], dtype=torch.int64))
            st.homogeneous = bool((sizes == st.local_size).all())
            log.debug("init: process mode rank %d/%d on %s", st.rank,
                      st.size, st.device)
            st.initialized = True
            _state = st
            return
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
        if _state.core is not None:
            _state.core.shutdown()
        else:
            dist.destroy_process_group()
        _state = _RuntimeState(epoch=_state.epoch)


def reinit() -> None:
    """Shut down and start again with the last ``init``'s arguments, the
    device included (JAX ``runtime.py:534``); the elastic retry loop's
    reset."""
    kwargs = dict(_init_kwargs)
    shutdown()
    init(**kwargs)


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


def epoch() -> int:
    """How many times this process has initialized the runtime: a new
    value means a new world."""
    return _require_init().epoch


def mode() -> str:
    """``"spmd"`` (the ``torch.distributed`` world) or ``"process"`` (the
    native core's)."""
    return _require_init().mode


def core():
    """This rank's :class:`~horovod_tpu_torch.basics.NativeCore` in
    process mode, else None."""
    return _require_init().core


def device() -> torch.device:
    """The device ``init`` chose for this rank."""
    return _require_init().device


def mesh():
    """The ranks' :class:`torch.distributed.device_mesh.DeviceMesh` (None
    in process mode, which creates no process group)."""
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
    other axes), or of the data-parallel axis (``None``; JAX
    ``_resolve_axis``, ``horovod_tpu/ops/collectives.py:71``). Every axis
    together is every rank."""
    st = _require_init()
    if axis is None:
        axis = st.dp_axis
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if st.mode == "process":
        if names != (DP_AXIS,):
            raise ValueError(f"process mode runs over the \"dp\" axis of "
                             f"every rank; got axis {axis!r}")
        return None
    unknown = [a for a in names if a not in st.axis_names]
    if unknown or not names or len(set(names)) != len(names):
        raise ValueError(f"axis {axis!r} does not name axes of the mesh "
                         f"{st.mesh_shape} once each")
    return st.groups[tuple(a for a in st.axis_names if a in names)]


def require_spmd(what: str) -> None:
    """Raise NotImplementedError in process mode for a part of the port
    that runs over ``torch.distributed`` process groups, which process mode
    does not create."""
    if _state.initialized and _state.mode == "process":
        raise NotImplementedError(
            f"{what} runs over torch.distributed process groups, which "
            "init(mode=\"process\") does not create; its process-mode "
            "port is queued (ROADMAP A8)")


def world_group():
    """The process group of every rank: for the exchanges that span the
    whole world whatever the mesh (the optimizer's layout check, the
    object collectives)."""
    if _require_init().mode == "process":
        return None
    return dist.group.WORLD


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
    return _state.initialized and _state.mode == "spmd" and \
        dist.get_backend() == "gloo"


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
