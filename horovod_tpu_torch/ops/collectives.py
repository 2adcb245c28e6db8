"""Collective operations over the ``torch.distributed`` world.

Counterpart of ``horovod_tpu/ops/collectives.py``: ``ReduceOp`` (:51),
``allreduce`` (:890), ``grouped_allreduce`` (:918), ``allgather`` (:971;
ranks may differ in dim 0), ``broadcast`` (:1003), ``alltoall`` (:1011;
optional uneven splits), ``reducescatter`` (:1032), the async handles
(:1061-1162: ``*_async``, ``poll``, ``synchronize``, ``release_handle``),
and :func:`send_recv` for the point-to-point exchanges the JAX package
writes as ``lax.ppermute``. Reference surface: ``horovod/torch/mpi_ops.py``.

Every op returns new tensors; its input is left as it was. They run over
the process group ``runtime.init`` created (NCCL on the card, gloo on the
CPU).

* **Agreement.** Before any data moves, each call a user makes (sync or
  async) gathers one fixed-size int64 descriptor from every rank (the
  operation, dtype, reduce op, root, shape and splits) and checks it by the
  port's copy of the rules of ``horovod_tpu/native/core.cpp:2501-2600``. On
  a mismatch every rank raises :class:`HvdTpuInternalError` with the
  reference's message. The exchange also gives every rank's dim 0, which
  the uneven allgather and alltoall need. It costs one small allgather and
  a host round trip; the port's own reducers and ``DistributedOptimizer``
  call the unchecked launches (``_launch_*``), whose layout agrees by
  construction.
* **Async.** Every op is a launch that returns a :class:`_Pending` (its
  ``dist.Work`` objects, the tensors they write, and what follows the
  exchange: Average's 1/size, the postscale, the wire decompression, the
  trim and the reshape). The synchronous op waits on it at once, so an
  async result is its sync twin, bitwise.
* **Autograd.** ``allreduce``, ``allgather``, ``broadcast`` and
  ``alltoall`` are differentiable when their input requires grad, with the
  reference binding's backward rules (``horovod_tpu/torch/__init__.py:
  166-370``).
"""

from __future__ import annotations

import enum
import itertools
import threading
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import runtime
from ..exceptions import HvdTpuInternalError


class ReduceOp(enum.IntEnum):
    """Reduction ops (values as ``horovod_tpu.ops.collectives.ReduceOp``)."""
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OPS = {
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}
# Product of these dtypes is taken in float32 (see _launch_reduce). Integer
# Product stays exact: the reference's exp(psum(log|x|)) truncates, for
# example 7 * 11 to 76 in int32, and the port does not copy that.
_WIDENED_PRODUCT = (torch.float16, torch.bfloat16)


def _apply_scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * factor`` as ``collectives._apply_scale`` in the JAX package
    computes it: integers scale in float32 and cast back; floating tensors
    multiply by the factor rounded to their own dtype
    (``jnp.asarray(factor, dtype=x.dtype)``). The factor is rounded here on
    the host and passed as a number, so no tensor goes to the device; a
    product of two bf16 or fp16 values is exact in the float32 that PyTorch
    multiplies them in, so the result is rounded once, to x's dtype."""
    if factor == 1.0:
        return x
    if not (x.is_floating_point() or x.is_complex()):
        return (x.to(torch.float32) * factor).to(x.dtype)
    return x * torch.tensor(factor, dtype=x.dtype).item()


# ---------------------------------------------------------------------------
# launches: one exchange started, and what follows it
# ---------------------------------------------------------------------------

class _Pending:
    """A launched exchange: its ``dist.Work`` objects and ``finish``, which
    runs after them and returns the result. ``finish`` holds the tensors
    the exchange writes, so they live until it is consumed."""

    __slots__ = ("works", "finish")

    def __init__(self, works: Sequence, finish: Callable):
        self.works = list(works)
        self.finish = finish

    def poll(self) -> bool:
        return all(w.is_completed() for w in self.works)

    def wait(self):
        for w in self.works:
            w.wait()
        return self.finish()


def _launch_reduce(x: torch.Tensor, op: ReduceOp, prescale: float,
                   postscale: float, scatter: bool = False,
                   inplace: bool = False) -> _Pending:
    """Allreduce (or, with ``scatter``, reduce-scatter along dim 0) a
    contiguous tensor. ``inplace`` lets the exchange write ``x`` itself."""
    if op not in _DIST_OPS:
        raise NotImplementedError(
            f"{op!r} is not ported yet (Adasum lands with the other "
            "data-parallel variants)")
    y = _apply_scale(x, prescale)
    widen = op == ReduceOp.PRODUCT and y.dtype in _WIDENED_PRODUCT
    if widen:
        # gloo and NCCL multiply 16-bit floats with a rounding at each hop;
        # the reference takes the product in float32 and casts it once.
        y = y.to(torch.float32)
    elif y is x and not inplace:
        y = x.clone()
    if scatter:
        out = torch.empty((y.shape[0] // runtime.size(),) + y.shape[1:],
                          dtype=y.dtype, device=y.device)
        work = dist.reduce_scatter_tensor(out, y, op=_DIST_OPS[op],
                                          async_op=True)
    else:
        out = y
        work = dist.all_reduce(y, op=_DIST_OPS[op], async_op=True)

    def finish():
        if widen:
            return _apply_scale(out.to(x.dtype), postscale)
        z = out
        if op == ReduceOp.AVERAGE:
            z = _apply_scale(z, 1.0 / runtime.size())
        return _apply_scale(z, postscale)
    return _Pending([work], finish)


def _launch_allreduce(x: torch.Tensor, op: ReduceOp, prescale: float,
                      postscale: float, compression=None) -> _Pending:
    ctx = None
    if compression is not None:
        x, ctx = compression.compress(x)
    shape = x.shape
    pending = _launch_reduce(x.reshape(-1), op, prescale, postscale)
    reduce_finish = pending.finish

    def finish():
        out = reduce_finish().view(shape)
        return out if compression is None else \
            compression.decompress(out, ctx)
    pending.finish = finish
    return pending


def _grouped_inputs(tensors, compression):
    """The wire tensors of a group (compressed where ``compression`` is
    given), their contexts, and their indices grouped by dtype and device
    in first-seen order: one fused buffer each."""
    tensors = list(tensors)
    ctxs = [None] * len(tensors)
    if compression is not None:
        pairs = [compression.compress(t) for t in tensors]
        tensors = [p[0] for p in pairs]
        ctxs = [p[1] for p in pairs]
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return tensors, ctxs, list(groups.values())


def _launch_grouped(tensors, op: ReduceOp, prescale: float,
                    postscale: float, compression=None) -> _Pending:
    """Allreduce a list of tensors as one fused buffer per dtype (reference:
    ``FuseResponses``, ``controller.cc:686``)."""
    tensors, ctxs, groups = _grouped_inputs(tensors, compression)
    pendings = [_launch_reduce(torch.cat([tensors[i].reshape(-1)
                                          for i in idxs]),
                               op, prescale, postscale, inplace=True)
                for idxs in groups]

    def finish():
        outs: List[torch.Tensor] = [None] * len(tensors)
        for idxs, pending in zip(groups, pendings):
            red = pending.finish()
            for i, part in zip(idxs, red.split([tensors[i].numel()
                                                for i in idxs])):
                outs[i] = part.view(tensors[i].shape)
        if compression is not None:
            outs = [compression.decompress(o, c) for o, c in zip(outs, ctxs)]
        return outs
    return _Pending([w for p in pendings for w in p.works], finish)


def _launch_allgather(x: torch.Tensor, dims: Sequence[int]) -> _Pending:
    """Concatenate every rank's rows; ``dims[r]`` is rank r's dim 0. Unequal
    ranks send padded to the largest and the result is trimmed (NCCL's
    ``all_gather_into_tensor`` takes equal sizes)."""
    x = (x.reshape(1) if x.dim() == 0 else x).contiguous()
    rows, rest = max(dims), tuple(x.shape[1:])
    if x.shape[0] < rows:
        x = torch.cat([x, x.new_zeros((rows - x.shape[0],) + rest)])
    out = torch.empty((len(dims) * rows,) + rest, dtype=x.dtype,
                      device=x.device)
    work = dist.all_gather_into_tensor(out, x, async_op=True)

    def finish():
        if all(d == rows for d in dims):
            return out
        return torch.cat([out[r * rows:r * rows + d]
                          for r, d in enumerate(dims)])
    return _Pending([work], finish)


def _launch_broadcast(x: torch.Tensor, root_rank: int,
                      inplace: bool = False) -> _Pending:
    out = x if inplace else x.clone(memory_format=torch.contiguous_format)
    work = dist.broadcast(out, src=root_rank, async_op=True)
    return _Pending([work], lambda: out)


def _launch_alltoall(x: torch.Tensor, send: Optional[Sequence[int]] = None,
                     recv: Optional[Sequence[int]] = None) -> _Pending:
    """Send ``send[r]`` rows to rank r and receive ``recv[r]`` from it, in
    rank order; without splits, equal dim-0 parts both ways."""
    x = x.contiguous()
    rows = x.shape[0] if recv is None else sum(recv)
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    work = dist.all_to_all_single(
        out, x, output_split_sizes=None if recv is None else list(recv),
        input_split_sizes=None if send is None else list(send),
        async_op=True)
    return _Pending([work], lambda: out)


# Internal exchanges of the reducers: every rank passes the same shapes, so
# they skip the agreement.

def _allgather_even(x: torch.Tensor) -> torch.Tensor:
    return _launch_allgather(x, [x.shape[0]] * runtime.size()).wait()


def _alltoall_even(x: torch.Tensor) -> torch.Tensor:
    return _launch_alltoall(x).wait()


def _broadcast(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    return _launch_broadcast(x, root_rank).wait()


# ---------------------------------------------------------------------------
# agreement (the port's copy of horovod_tpu/native/core.cpp:2501-2600)
# ---------------------------------------------------------------------------

_OPS = ("allreduce", "allgather", "broadcast", "alltoall", "reducescatter",
        "DistributedOptimizer")
_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
           torch.int64, torch.float16, torch.bfloat16, torch.float32,
           torch.float64, torch.complex64, torch.complex128)
_MAX_DIMS = 8  # dims past the 8th are folded into a checksum in the last
_OP, _DTYPE, _REDUCE, _ROOT, _NDIM, _SIG, _SPLITS_LEN, _SPLITS_SUM, \
    _SPLITS_MIN, _DIMS = range(10)
_WORDS = _DIMS + _MAX_DIMS


def _dtype_code(dtype: torch.dtype) -> int:
    return _DTYPES.index(dtype) if dtype in _DTYPES else \
        len(_DTYPES) + zlib.crc32(str(dtype).encode())


def _dtype_name(code: int) -> str:
    return str(_DTYPES[code]).replace("torch.", "") \
        if code < len(_DTYPES) else f"dtype #{code}"


def _describe(kind: str, shape: Sequence[int], dtype: torch.dtype,
              op: int = -1, root: int = -1, sig: int = 0,
              splits: Optional[Sequence[int]] = None) -> List[int]:
    """This rank's descriptor of one call: ``_WORDS`` int64 words."""
    shape = list(shape)
    dims = shape[:_MAX_DIMS]
    if len(shape) > _MAX_DIMS:
        dims[-1] = zlib.crc32(repr(shape[_MAX_DIMS - 1:]).encode())
    dims += [0] * (_MAX_DIMS - len(dims))
    if splits is None:
        split_words = [-1, 0, 0]
    else:
        split_words = [len(splits), sum(splits), min(splits, default=0)]
    return [_OPS.index(kind), _dtype_code(dtype), int(op), root, len(shape),
            sig, *split_words, *dims]


def _shape_str(row: Sequence[int]) -> str:
    dims = [str(d) for d in row[_DIMS:_DIMS + min(row[_NDIM], _MAX_DIMS)]]
    if row[_NDIM] > _MAX_DIMS:
        dims[-1] = "..."
    return "[" + ", ".join(dims) + "]"


def _dims_equal(a: Sequence[int], b: Sequence[int], start: int) -> bool:
    return a[_NDIM] == b[_NDIM] and \
        a[_DIMS + start:_DIMS + _MAX_DIMS] == b[_DIMS + start:_DIMS + _MAX_DIMS]


def _check(rows: Sequence[Sequence[int]], name: Optional[str] = None
           ) -> None:
    """Raise :class:`HvdTpuInternalError` unless the descriptors of every
    rank agree (reference: ``ConstructResponse``, ``core.cpp:2501-2600``).
    Every rank runs it on the same rows, so every rank raises alike."""
    n = len(rows)
    first = rows[0]
    kind = _OPS[first[_OP]]
    where = f" for tensor '{name}'" if name else ""

    def fail(msg):
        raise HvdTpuInternalError(msg + where)

    for r, q in enumerate(rows[1:], 1):
        if q[_OP] != first[_OP]:
            fail(f"Mismatched collective operations: rank 0 requested "
                 f"{kind} but rank {r} requested {_OPS[q[_OP]]}")
        if q[_DTYPE] != first[_DTYPE]:
            fail(f"Mismatched data types: rank 0 has "
                 f"{_dtype_name(first[_DTYPE])} but rank {r} has "
                 f"{_dtype_name(q[_DTYPE])}")
    if kind in ("allreduce", "reducescatter", "DistributedOptimizer"):
        for r, q in enumerate(rows[1:], 1):
            same_dims = _dims_equal(q, first, 0)
            if kind == "DistributedOptimizer" and (
                    not same_dims or q[_SIG] != first[_SIG]):
                fail(f"Mismatched DistributedOptimizer layouts: rank 0 and "
                     f"rank {r} bucket different gradients")
            if not same_dims:
                fail(f"Mismatched {kind} tensor shapes: rank 0 has "
                     f"{_shape_str(first)} but rank {r} has {_shape_str(q)}")
            if q[_SIG] != first[_SIG]:
                fail(f"Mismatched {kind} tensor shapes: rank 0 and rank {r} "
                     f"pass different groups of tensors")
            if q[_REDUCE] != first[_REDUCE]:
                fail(f"Mismatched reduce ops: rank 0 has "
                     f"{ReduceOp(first[_REDUCE]).name} but rank {r} has "
                     f"{ReduceOp(q[_REDUCE]).name}")
        if kind == "reducescatter" and first[_NDIM] == 0:
            fail("reducescatter takes a tensor of at least one dimension")
        if kind == "reducescatter" and first[_DIMS] % n != 0:
            fail(f"reducescatter first dimension ({first[_DIMS]}) must be "
                 f"divisible by world size ({n})")
    elif kind == "allgather":
        for r, q in enumerate(rows[1:], 1):
            if q[_NDIM] != first[_NDIM]:
                fail(f"Mismatched allgather tensor ranks: rank 0 has "
                     f"rank-{first[_NDIM]} tensor but rank {r} has "
                     f"rank-{q[_NDIM]} tensor")
            if not _dims_equal(q, first, 1):
                fail(f"Mismatched allgather tensor shapes beyond the first "
                     f"dimension: rank 0 has {_shape_str(first)} but rank "
                     f"{r} has {_shape_str(q)}")
    elif kind == "broadcast":
        for r, q in enumerate(rows[1:], 1):
            if q[_ROOT] != first[_ROOT]:
                fail(f"Mismatched broadcast root ranks: rank 0 has root "
                     f"{first[_ROOT]} but rank {r} has root {q[_ROOT]}")
            if not _dims_equal(q, first, 0):
                fail(f"Mismatched broadcast tensor shapes: rank 0 has "
                     f"{_shape_str(first)} but rank {r} has {_shape_str(q)}")
        if not 0 <= first[_ROOT] < n:
            fail(f"broadcast root rank {first[_ROOT]} is outside a world of "
                 f"{n}")
    elif kind == "alltoall":
        for r, q in enumerate(rows):
            dim0 = q[_DIMS]
            if q[_NDIM] == 0:
                fail(f"alltoall takes a tensor of at least one dimension, "
                     f"rank {r} has a scalar")
            if q[_SPLITS_LEN] < 0:
                if dim0 % n:
                    fail(f"alltoall first dimension ({dim0}) is not "
                         f"divisible by world size ({n}) and no splits were "
                         f"given on rank {r}")
                continue
            if q[_SPLITS_LEN] != n:
                fail(f"alltoall splits length ({q[_SPLITS_LEN]}) != world "
                     f"size ({n}) on rank {r}")
            if q[_SPLITS_MIN] < 0:
                fail(f"alltoall splits must not be negative on rank {r}")
            if q[_SPLITS_SUM] != dim0:
                fail(f"alltoall splits sum ({q[_SPLITS_SUM]}) != first "
                     f"dimension ({dim0}) on rank {r}")
        for r, q in enumerate(rows[1:], 1):
            if not _dims_equal(q, first, 1):
                fail(f"Mismatched alltoall tensor shapes beyond the first "
                     f"dimension: rank 0 has {_shape_str(first)} but rank "
                     f"{r} has {_shape_str(q)}")


def _exchange(words: Sequence[int]) -> List[List[int]]:
    """Every rank's row of ``words`` (one allgather on the runtime's
    device and a copy to the host)."""
    dev = runtime.device()
    mine = torch.tensor(list(words), dtype=torch.int64, device=dev)
    rows = torch.empty(runtime.size() * mine.numel(), dtype=torch.int64,
                       device=dev)
    dist.all_gather_into_tensor(rows, mine)
    return rows.view(runtime.size(), -1).tolist()


def _agree(kind: str, shape: Sequence[int], dtype: torch.dtype,
           name: Optional[str] = None, **kw) -> List[List[int]]:
    """Gather every rank's descriptor, check them, and return them."""
    rows = _exchange(_describe(kind, shape, dtype, **kw))
    _check(rows, name)
    return rows


def _group_signature(tensors: Sequence[torch.Tensor],
                     dtypes: Sequence[torch.dtype]) -> int:
    """A checksum of a group's dtypes and shapes, in order."""
    return zlib.crc32(repr([(_dtype_code(d), tuple(t.shape))
                            for t, d in zip(tensors, dtypes)]).encode())


# ---------------------------------------------------------------------------
# autograd (reference binding: horovod_tpu/torch/__init__.py:166-370)
# ---------------------------------------------------------------------------

def _wants_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


class _AllreduceFn(torch.autograd.Function):
    """The grad of an allreduce is an allreduce with the same op and
    scales."""

    @staticmethod
    def forward(ctx, x, op, prescale, postscale):
        ctx.args = (op, prescale, postscale)
        return _launch_allreduce(x, op, prescale, postscale).wait()

    @staticmethod
    def backward(ctx, grad):
        return (_launch_allreduce(grad, *ctx.args).wait(), None, None,
                None)


class _AllgatherFn(torch.autograd.Function):
    """An allgather's grad is summed over the ranks, then this rank takes
    its rows."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.shape = x.shape
        ctx.offset = sum(dims[:runtime.rank()])
        return _launch_allgather(x, dims).wait()

    @staticmethod
    def backward(ctx, grad):
        summed = _launch_allreduce(grad, ReduceOp.SUM, 1.0, 1.0).wait()
        rows = 1 if len(ctx.shape) == 0 else ctx.shape[0]
        return summed[ctx.offset:ctx.offset + rows].reshape(ctx.shape), None


class _BroadcastFn(torch.autograd.Function):
    """A broadcast's grad is summed onto the root; the other ranks get
    zeros."""

    @staticmethod
    def forward(ctx, x, root_rank):
        ctx.root_rank = root_rank
        return _launch_broadcast(x, root_rank).wait()

    @staticmethod
    def backward(ctx, grad):
        summed = _launch_allreduce(grad, ReduceOp.SUM, 1.0, 1.0).wait()
        if runtime.rank() != ctx.root_rank:
            summed = torch.zeros_like(summed)
        return summed, None


class _AlltoallFn(torch.autograd.Function):
    """An alltoall's grad routes home: what came from rank r goes back to
    it."""

    @staticmethod
    def forward(ctx, x, send, recv):
        ctx.splits = (send, recv)
        return _launch_alltoall(x, send, recv).wait()

    @staticmethod
    def backward(ctx, grad):
        send, recv = ctx.splits
        return _launch_alltoall(grad, recv, send).wait(), None, None


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

def _wire_dtype(x: torch.Tensor, compression) -> torch.dtype:
    if compression is None:
        return x.dtype
    return compression.compress(x.new_empty(0))[0].dtype


def _plan_allreduce(x, op, compression, name):
    _agree("allreduce", x.shape, _wire_dtype(x, compression), name, op=op)


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None, name: Optional[str] = None) -> torch.Tensor:
    """Allreduce a tensor across ranks; Average by default (reference:
    ``hvd.allreduce``, ``horovod/torch/mpi_ops.py:132``). ``compression``
    (``Compression.fp16``/``bf16``) casts the payload for the wire.
    Differentiable."""
    _plan_allreduce(x, op, compression, name)
    if _wants_grad(x):
        if compression is not None:
            wire, ctx = compression.compress(x)
            return compression.decompress(_AllreduceFn.apply(
                wire, op, prescale_factor, postscale_factor), ctx)
        return _AllreduceFn.apply(x, op, prescale_factor, postscale_factor)
    return _launch_allreduce(x, op, prescale_factor, postscale_factor,
                             compression).wait()


def _plan_grouped(tensors, op, compression, name):
    dtypes = [_wire_dtype(t, compression) for t in tensors]
    _agree("allreduce", (sum(t.numel() for t in tensors),),
           dtypes[0] if dtypes else torch.float32, name, op=op,
           sig=_group_signature(tensors, dtypes))


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=None, name: Optional[str] = None
                      ) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused buffer per dtype (reference:
    ``FuseResponses``, ``controller.cc:686``)."""
    tensors = list(tensors)
    _plan_grouped(tensors, op, compression, name)
    return _launch_grouped(tensors, op, prescale_factor, postscale_factor,
                           compression).wait()


def _plan_allgather(x, name) -> List[int]:
    rows = _agree("allgather", x.shape, x.dtype, name)
    return [r[_DIMS] if r[_NDIM] else 1 for r in rows]


def allgather(x: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; ranks may differ in dim
    0 (reference: ``hvd.allgather``, ``mpi_ops.py:238``; a scalar counts as
    one row). Differentiable."""
    dims = _plan_allgather(x, name)
    if _wants_grad(x):
        return _AllgatherFn.apply(x, dims)
    return _launch_allgather(x, dims).wait()


def broadcast(x: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """Return ``root_rank``'s tensor on every rank (reference:
    ``hvd.broadcast``, ``mpi_ops.py:387``). Differentiable."""
    _agree("broadcast", x.shape, x.dtype, name, root=root_rank)
    if _wants_grad(x):
        return _BroadcastFn.apply(x, root_rank)
    return _launch_broadcast(x, root_rank).wait()


def broadcast_(x: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place broadcast (reference: ``hvd.broadcast_``). A dense tensor
    (``channels_last`` included) is broadcast where it lies."""
    _agree("broadcast", x.shape, x.dtype, name, root=root_rank)
    if x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last)):
        _launch_broadcast(x, root_rank, inplace=True).wait()
    else:
        x.copy_(_launch_broadcast(x, root_rank).wait())
    return x


def _splits_list(splits) -> Optional[List[int]]:
    if splits is None:
        return None
    return [int(s) for s in torch.as_tensor(splits).reshape(-1).tolist()]


def _plan_alltoall(x, splits, name):
    """The send and receive splits of this rank (None, None when every rank
    sends equal parts of the same dim 0) and the received splits."""
    rows = _agree("alltoall", x.shape, x.dtype, name, splits=splits)
    n, me = runtime.size(), runtime.rank()
    if splits is None and all(r[_SPLITS_LEN] < 0 for r in rows) and \
            all(r[_DIMS] == rows[0][_DIMS] for r in rows):
        part = x.shape[0] // n
        return None, None, [part] * n
    if any(r[_SPLITS_LEN] >= 0 for r in rows):
        # Every rank's send vector: rank s sends matrix[s][r] rows to r.
        mine = splits if splits is not None else [x.shape[0] // n] * n
        matrix = _exchange(mine)
    else:
        matrix = [[r[_DIMS] // n] * n for r in rows]
    send = list(matrix[me])
    recv = [matrix[s][me] for s in range(n)]
    return send, recv, recv


def alltoall(x: torch.Tensor, splits=None, name: Optional[str] = None):
    """Send dim-0 parts of ``x`` to every rank and concatenate what each
    rank sent here, in rank order (reference: ``hvd.alltoall``,
    ``operations.cc:1055-1116``). Without ``splits`` the parts are equal and
    the output is returned alone; with ``splits`` (rows to each rank) it
    returns ``(output, received_splits)``, the rows that came from each
    rank as an int32 tensor on the CPU. Differentiable."""
    splits = _splits_list(splits)
    send, recv, received = _plan_alltoall(x, splits, name)
    if _wants_grad(x):
        out = _AlltoallFn.apply(x, send, recv)
    else:
        out = _launch_alltoall(x, send, recv).wait()
    if splits is None:
        return out
    return out, torch.tensor(received, dtype=torch.int32)


def reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce across ranks and keep this rank's part of dim 0, which every
    rank's world size divides (reference: ``hvd.reducescatter``,
    ``collectives.py:1032``); Average scales as ``allreduce`` does."""
    _agree("reducescatter", x.shape, x.dtype, name, op=op)
    return _launch_reduce(x.contiguous(), op, prescale_factor,
                          postscale_factor, scatter=True).wait()


# ---------------------------------------------------------------------------
# async handles (reference: collectives.py:1061-1162)
# ---------------------------------------------------------------------------

_handles: Dict[int, _Pending] = {}
_handle_lock = threading.Lock()
_handle_ids = itertools.count(1)


def _register(pending: _Pending) -> int:
    with _handle_lock:
        handle = next(_handle_ids)
        _handles[handle] = pending
    return handle


def _take(handle: int) -> _Pending:
    with _handle_lock:
        pending = _handles.pop(handle, None)
    if pending is None:
        raise ValueError(f"unknown handle {handle}")
    return pending


def allreduce_async(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, compression=None,
                    name: Optional[str] = None) -> int:
    """Start :func:`allreduce` and return its handle (reference:
    ``allreduce_async``, ``mpi_ops.py:132``)."""
    _plan_allreduce(x, op, compression, name)
    return _register(_launch_allreduce(x, op, prescale_factor,
                                       postscale_factor, compression))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: ReduceOp = ReduceOp.AVERAGE,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None,
                            name: Optional[str] = None) -> int:
    """Start :func:`grouped_allreduce`; its handle synchronizes to the
    list."""
    tensors = list(tensors)
    _plan_grouped(tensors, op, compression, name)
    return _register(_launch_grouped(tensors, op, prescale_factor,
                                     postscale_factor, compression))


def allgather_async(x: torch.Tensor, name: Optional[str] = None) -> int:
    """Start :func:`allgather` (the ranks' dim 0 are exchanged first)."""
    return _register(_launch_allgather(x, _plan_allgather(x, name)))


def broadcast_async(x: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None) -> int:
    _agree("broadcast", x.shape, x.dtype, name, root=root_rank)
    return _register(_launch_broadcast(x, root_rank))


def alltoall_async(x: torch.Tensor, splits=None,
                   name: Optional[str] = None) -> int:
    """Start :func:`alltoall`. As in the reference, its handle
    synchronizes to the output alone, with or without ``splits``."""
    send, recv, _ = _plan_alltoall(x, _splits_list(splits), name)
    return _register(_launch_alltoall(x, send, recv))


def poll(handle: int) -> bool:
    """True when the exchange behind ``handle`` has completed (reference:
    ``poll``, ``mpi_ops.py:594``); ``synchronize`` is still needed for the
    result."""
    with _handle_lock:
        pending = _handles.get(handle)
    if pending is None:
        raise ValueError(f"unknown handle {handle}")
    return pending.poll()


def synchronize(handle: int):
    """Wait for the exchange behind ``handle`` and return its result, as
    the synchronous op would (reference: ``synchronize``,
    ``mpi_ops.py:610``)."""
    return _take(handle).wait()


def release_handle(handle: int) -> None:
    """Drop a handle without its result; the exchange is waited for
    first, so its tensors outlive it."""
    for work in _take(handle).works:
        work.wait()


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------

def send_recv(send: Optional[Dict[str, torch.Tensor]] = None,
              dst: Optional[int] = None,
              recv_like: Optional[Dict[str, torch.Tensor]] = None,
              src: Optional[int] = None
              ) -> Optional[Dict[str, torch.Tensor]]:
    """Send the tensors of ``send`` to rank ``dst`` and receive tensors
    shaped like those of ``recv_like`` from rank ``src``, in one
    ``batch_isend_irecv`` (one rank's part of a ``lax.ppermute``). Either
    side may be left out; the tensors go in the order of their sorted
    names. Returns the received tensors, or None."""
    ops = []
    if send is not None:
        ops += [dist.P2POp(dist.isend, send[k].contiguous(), dst)
                for k in sorted(send)]
    received = None
    if recv_like is not None:
        received = {k: torch.empty_like(
                        v, memory_format=torch.contiguous_format)
                    for k, v in recv_like.items()}
        ops += [dist.P2POp(dist.irecv, received[k], src)
                for k in sorted(received)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return received
