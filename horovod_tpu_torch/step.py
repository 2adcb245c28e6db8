"""Compiled step: the whole training step captured in a CUDA graph.

Counterpart of ``horovod_tpu/step.py``: ``REPLICATED`` (:25),
``batch_spec`` (:28), ``run_step`` (:36), ``data_parallel_step`` (:74),
``shard_batch`` (:88) and ``replicate`` (:103). The JAX package traces a
step once and runs it as one compiled SPMD program over the mesh. Here each
rank is one process driving one GPU, and the counterpart of that program is
a ``torch.cuda.CUDAGraph`` of the whole step on the rank's card: forward,
backward, the reductions that ``DistributedOptimizer``'s hooks launch
(NCCL and the compression kernels) and the optimizer's update, replayed by
one launch::

    def train_step(model, opt, batch):
        images, labels = batch
        opt.zero_grad(set_to_none=True)
        with torch.autocast("cuda", torch.bfloat16, cache_enabled=False):
            logits = model(images)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    step = hvd.data_parallel_step(train_step)
    batch = hvd.shard_batch((images, labels))    # this rank's block
    for _ in range(steps):
        loss = step(model, opt, batch)

A spec is a tuple with one entry a leading dim, as a ``PartitionSpec``
(:mod:`horovod_tpu_torch.parallel.axes`, whose ``local_shard`` cuts a
rank's block by it).
"""

from __future__ import annotations

import functools
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from . import runtime
from .parallel.axes import REPLICATED, batch_spec, local_shard

__all__ = ["REPLICATED", "batch_spec", "run_step", "data_parallel_step",
           "shard_batch", "replicate"]

# Eager calls of a key before its capture. What a step makes once is made
# in them: the optimizer's error-feedback residuals, momentum buffers and
# fused buckets, NCCL's communicators, cuBLAS's workspaces, the quantizers'
# level tables on the card, cuDNN's chosen algorithms. The optimizer's
# first step in a world, whose synchronize() exchanges the layout on the
# host and whose hooks only count, has a key of its own
# (``_window_key``) and is never captured. Torch asks for 11 warm-up
# iterations under DDP, which changes its buckets and logs its statistics
# over its first iterations; the port's hooks have no such schedule: the
# second step of a world is the one every later step repeats. One more
# call is margin.
WARMUP_CALLS = 2
_NCCL_CAPTURE = (2, 9, 6)  # the first NCCL whose kernels a graph can hold
_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh is not runtime.mesh():
        raise ValueError("each rank of the port runs its part of the step on "
                         "the runtime's mesh; pass mesh=None")


def _put(x, dev: torch.device, spec) -> torch.Tensor:
    """A copy of this rank's block of ``x`` under ``spec`` on ``dev``."""
    block = local_shard(torch.as_tensor(x), spec)
    return block.to(dev, copy=True, memory_format=torch.contiguous_format)


def shard_batch(batch, dim: int = 0, axis: Optional[str] = None, mesh=None):
    """This rank's block of every leaf of a host pytree, on the rank's
    device: dim ``dim`` split over mesh axis ``axis`` (the data-parallel
    axis by default), the block JAX's ``shard_batch`` places on this rank's
    device. Leaves may be tensors or numpy arrays."""
    _check_mesh(mesh)
    spec, dev = batch_spec(dim, axis), runtime.device()
    return tree_map(lambda x: _put(x, dev, spec), batch)


def replicate(tree, mesh=None):
    """Every leaf of a host pytree, whole, on this rank's device. Like the
    JAX package's ``device_put`` it copies and does not broadcast: the
    ranks hold what each passed."""
    _check_mesh(mesh)
    dev = runtime.device()
    return tree_map(lambda x: _put(x, dev, REPLICATED), tree)


class _Entry:
    """One key's warm-up count, and after its capture the graph, its
    static input and output tensors and the snapshots of its stateful
    arguments."""

    __slots__ = ("calls", "graph", "static_in", "static_out", "snapshots",
                 "capture_s")

    def __init__(self):
        self.calls = 0
        self.graph = None
        self.static_in: List[torch.Tensor] = []
        self.static_out = None
        self.snapshots: list = []
        self.capture_s = None


def _clone_out(out):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, out)


def _capture_error(name: str, exc: BaseException) -> RuntimeError:
    """The error of a failed capture, naming the line that broke it (the
    innermost frame of the first exception) and the step function's line
    that led there."""
    first = exc
    while first.__context__ is not None:
        first = first.__context__
    frames = traceback.extract_tb(first.__traceback__)
    own = [f for f in frames if not os.path.abspath(f.filename).startswith(
        (_HERE, _TORCH))]

    def where(frame) -> str:
        return f"{frame.filename}:{frame.lineno} ({frame.line})"
    at = where(frames[-1]) if frames else "an unknown operation"
    if own and own[-1] is not frames[-1]:
        at += f", called from {where(own[-1])}"
    return RuntimeError(
        f"run_step: capturing {name} in a CUDA graph failed at {at}: "
        f"{type(first).__name__}: {str(first).splitlines()[0]}. A captured "
        f"step may not copy a tensor to the host (.item(), .tolist(), "
        f".cpu(), bool() of a tensor), synchronize a stream or the device, "
        f"or run a process-mode collective; do that outside the step. "
        f"Nothing ran eagerly in its place.")


class Step:
    """A step function made by :func:`run_step`; call it as the function.
    ``keys()`` lists its cache keys (one graph each, on the card)."""

    def __init__(self, fn, in_specs, mesh, static_argnums):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.in_specs = in_specs
        self.mesh = mesh
        self.static_argnums = ((static_argnums,)
                               if isinstance(static_argnums, int)
                               else tuple(static_argnums))
        self._entries: Dict[tuple, _Entry] = {}
        self._stream = None

    def keys(self) -> list:
        return list(self._entries)

    def entry(self, key) -> _Entry:
        return self._entries[key]

    def _key(self, args):
        """(key, the tensor leaves in order, the stateful arguments). The
        runtime's epoch leads it: a graph's collectives belong to the world
        it was captured in."""
        parts, tensors, stateful = [("world", runtime.epoch())], [], []
        for i, arg in enumerate(args):
            if i in self.static_argnums:
                parts.append(("static", arg))
            elif isinstance(arg, (torch.Tensor, tuple, list, dict)):
                leaves, spec = tree_flatten(arg)
                shapes = []
                for leaf in leaves:
                    if isinstance(leaf, torch.Tensor):
                        tensors.append(leaf)
                        shapes.append((tuple(leaf.shape), leaf.dtype,
                                       leaf.device))
                    else:
                        shapes.append(("value", leaf))
                parts.append((str(spec), tuple(shapes)))
            else:
                window = getattr(arg, "_window_key", None)
                if window is not None:
                    stateful.append(arg)
                parts.append(("object", id(arg),
                              window() if window is not None else None,
                              getattr(arg, "training", None)))
        key = tuple(parts)
        try:
            hash(key)
        except TypeError as exc:
            raise TypeError(f"run_step: a static argument or a non-tensor "
                            f"leaf is not hashable: {exc}") from None
        return key, tensors, stateful

    def __call__(self, *args):
        if runtime.mode() == "process":
            raise NotImplementedError(
                "run_step captures the step in one CUDA graph; in process "
                "mode (init(mode=\"process\")) the native core stages every "
                "tensor through pinned host memory and synchronizes the "
                "stream, which no graph can hold: call the step function "
                "itself")
        _check_mesh(self.mesh)
        if isinstance(self.in_specs, (tuple, list)) and \
                len(self.in_specs) != len(args):
            raise ValueError(f"run_step: {len(self.in_specs)} in_specs for "
                             f"{len(args)} arguments")
        key, tensors, stateful = self._key(args)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry()
        if runtime.device().type != "cuda":
            entry.calls += 1
            with runtime.stepping():
                return self._fn(*args)
        if entry.graph is not None:
            return self._replay(entry, tensors, stateful)
        if entry.calls < WARMUP_CALLS:
            entry.calls += 1
            return self._warm_up(args)
        entry.calls += 1
        return self._capture(entry, args, stateful)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=runtime.device())
        return self._stream

    def _warm_up(self, args):
        """One eager step on the side stream the capture will use."""
        stream = self._side_stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), runtime.stepping():
            out = self._fn(*args)
        torch.cuda.current_stream().wait_stream(stream)
        return out

    def _capture(self, entry: _Entry, args, stateful):
        """Capture ``fn`` on copies of the tensor arguments, then replay
        the graph once: this call is a step too."""
        if dist.is_initialized() and dist.get_backend() == "nccl" and \
                torch.cuda.nccl.version() < _NCCL_CAPTURE:
            raise RuntimeError(
                f"run_step: NCCL {torch.cuda.nccl.version()} cannot be "
                f"captured in a CUDA graph (2.9.6 or later can)")
        static_args = []
        for i, arg in enumerate(args):
            if i in self.static_argnums or not isinstance(
                    arg, (torch.Tensor, tuple, list, dict)):
                static_args.append(arg)
                continue
            leaves, spec = tree_flatten(arg)
            leaves = [leaf.detach().clone() if isinstance(leaf, torch.Tensor)
                      else leaf for leaf in leaves]
            entry.static_in += [leaf for leaf in leaves
                                if isinstance(leaf, torch.Tensor)]
            static_args.append(tree_unflatten(leaves, spec))
        graph = torch.cuda.CUDAGraph()
        before = torch.cuda.current_stream()
        t0 = time.perf_counter()
        try:
            with runtime.stepping(), \
                    torch.cuda.graph(graph, stream=self._side_stream()):
                out = self._fn(*static_args)
        except Exception as exc:
            # A capture_end that raises leaves the capture stream current.
            torch.cuda.set_stream(before)
            entry.static_in = []
            raise _capture_error(getattr(self._fn, "__name__", "the step"),
                                 exc) from exc
        entry.snapshots = [(obj, obj._window_snapshot()) for obj in stateful]
        entry.graph, entry.static_out = graph, out
        graph.replay()
        entry.capture_s = time.perf_counter() - t0
        return _clone_out(out)

    def _replay(self, entry: _Entry, tensors, stateful):
        for static, given in zip(entry.static_in, tensors):
            static.copy_(given)
        entry.graph.replay()
        for obj, snapshot in entry.snapshots:
            obj._window_restore(snapshot)
        return _clone_out(entry.static_out)


def run_step(fn=None, *, in_specs, out_specs, mesh=None,
             donate_argnums: Sequence[int] = (), static_argnums=(),
             check_vma: bool = True):
    """The step function ``fn`` as one compiled step (JAX ``run_step``:
    ``jit`` of ``shard_map``); also a decorator, as JAX's is.

    Arguments are positional. A pytree of tensors (a tensor, tuple, list
    or dict) is data: under :func:`batch_spec` it is this rank's block, as
    :func:`shard_batch` gives it; under :data:`REPLICATED`, the whole
    value. Any other argument is an object passed as it is: a module or an
    optimizer, whose tensors are state the step updates in place (the
    port's form of a donated replicated argument; ``donate_argnums`` is
    taken for the signature), or a plain value. ``static_argnums`` values
    are part of the cache key, as under ``jit``. ``out_specs`` is taken for
    the signature: each rank returns its own outputs.

    The cache key is the world (``init`` anew, as after an elastic reset,
    starts new graphs), the tensors' shapes, dtypes and devices, the static
    values, the identity (and a module's ``training``) of each object, and
    an optimizer's position in its window (``DistributedOptimizer``: one
    graph for each of the ``backward_passes_per_step`` passes, replayed in
    turn). A new key keeps the old ones.

    On a CUDA device every call is exactly one step. The first
    ``WARMUP_CALLS`` calls of a key run ``fn`` eagerly on a side stream;
    the next captures it into a ``torch.cuda.CUDAGraph``, its tensor
    arguments copied into static buffers, and replays it once; later
    calls copy their tensors in and replay. Tensor outputs are returned as
    clones, so the next replay does not overwrite them. A replay runs no
    Python: an optimizer's countdowns are put back as the capture left
    them, and the launch counters of the kernel wrappers count the warm-up
    and the capture only. A capture that fails raises, naming the line that
    broke it (a ``.item()``, ``.tolist()`` or ``.cpu()`` in ``fn``, a
    stream synchronized); nothing runs eagerly in its place. In ``fn``, use
    ``torch.autocast(..., cache_enabled=False)``, fix cuDNN's choice of
    algorithms (``torch.backends.cudnn.benchmark`` searches in the warm-up
    calls, and must not search again), and keep the learning rate as the
    capture saw it (a scheduler's new value is not replayed).

    On the CPU (``init(device="cpu")``) ``fn`` runs eagerly at every call:
    the counterpart of ``jit`` where no graph exists, not a fallback. In
    process mode (``init(mode="process")``) calling the step raises.

    ``check_vma`` is taken for the signature. JAX checks that what
    ``shard_map`` returns as replicated is invariant over the mesh; the
    port's in-step operators carry their invariance rules in their own
    code (:mod:`horovod_tpu_torch.ops.spmd`), so there is nothing to check.
    Inside ``fn``, :func:`~horovod_tpu_torch.ops.collectives.rank_in_step`,
    ``size_in_step`` and ``in_named_trace`` answer for the mesh's axes.
    """
    if fn is None:
        return functools.partial(run_step, in_specs=in_specs,
                                 out_specs=out_specs, mesh=mesh,
                                 donate_argnums=donate_argnums,
                                 static_argnums=static_argnums,
                                 check_vma=check_vma)
    return Step(fn, in_specs, mesh, static_argnums)


def data_parallel_step(train_step, donate_state: bool = True,
                       batch_dim: int = 0, mesh=None):
    """:func:`run_step` of ``train_step(model, optimizer, batch)`` with
    ``(REPLICATED, REPLICATED, batch_spec(batch_dim))``: the model and the
    optimizer (a ``DistributedOptimizer``, whose hooks reduce the
    gradients) updated in place, the batch this rank's block. The JAX
    package's ``train_step(params, opt_state, batch)`` returns the new
    state; here the state lives in the module and the optimizer, so
    ``donate_state=False`` (keep the old state) raises ``ValueError``."""
    if not donate_state:
        raise ValueError(
            "data_parallel_step(donate_state=False): the port's state lives "
            "in the module and the optimizer, which the step updates in "
            "place; there is no old state to keep")
    return run_step(train_step,
                    in_specs=(REPLICATED, REPLICATED, batch_spec(batch_dim)),
                    out_specs=REPLICATED, mesh=mesh, donate_argnums=(0, 1))
