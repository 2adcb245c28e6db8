"""Collective operations over the ``torch.distributed`` world.

Counterpart of ``horovod_tpu/ops/collectives.py``: ``ReduceOp`` (:51),
``allreduce`` (:890), ``grouped_allreduce`` (:918), ``allgather`` (:971;
ranks may differ in dim 0), ``broadcast`` (:1003), ``alltoall`` (:1011;
optional uneven splits), ``reducescatter`` (:1032), the async handles
(:1061-1162: ``*_async``, ``poll``, ``synchronize``, ``release_handle``),
:func:`send_recv` for the point-to-point exchanges the JAX package writes
as ``lax.ppermute``, and the two-level reductions over two mesh axes,
:func:`hierarchical_allreduce` and :func:`hierarchical_allgather`
(``hierarchical_allreduce_p`` :348, ``hierarchical_allgather_p`` :404).
Reference surface: ``horovod/torch/mpi_ops.py``.

Every op returns new tensors; its input is left as it was. They run over
every rank, or with ``axis=`` over a mesh axis's process group
(``runtime.group``; NCCL on the card, gloo on the CPU): sizes, ranks,
roots and Average's divisor are then the group's. ``op=Adasum`` runs the
VHDD exchange of :mod:`horovod_tpu_torch.parallel.adasum`, each tensor of
a group with its own coefficients.

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


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _global(group, rank: int) -> int:
    """The world rank of ``group``'s rank ``rank``."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _launch_reduce(x: torch.Tensor, op: ReduceOp, prescale: float,
                   postscale: float, scatter: bool = False,
                   inplace: bool = False, group=None,
                   sizes: Optional[Sequence[int]] = None) -> _Pending:
    """Allreduce (or, with ``scatter``, reduce-scatter along dim 0) a
    contiguous tensor over ``group`` (every rank by default). ``inplace``
    lets the exchange write ``x`` itself. Adasum takes ``sizes``, the
    lengths of the tensors fused in ``x``: each gets its own
    coefficients."""
    group = dist.group.WORLD if group is None else group
    if op == ReduceOp.ADASUM:
        if scatter:
            raise ValueError("reducescatter does not take Adasum")
        from ..parallel.adasum import adasum
        out = adasum(_apply_scale(x, prescale), group=group, sizes=sizes)
        if out is x and not inplace:  # one rank: Adasum is the identity
            out = x.clone()
        return _Pending([], lambda: _apply_scale(out, postscale))
    if op not in _DIST_OPS:
        raise ValueError(f"unknown ReduceOp {op!r}")
    y = _apply_scale(x, prescale)
    widen = op == ReduceOp.PRODUCT and y.dtype in _WIDENED_PRODUCT
    if widen:
        # gloo and NCCL multiply 16-bit floats with a rounding at each hop;
        # the reference takes the product in float32 and casts it once.
        y = y.to(torch.float32)
    elif y is x and not inplace:
        y = x.clone()
    if scatter:
        out = torch.empty((y.shape[0] // _size(group),) + y.shape[1:],
                          dtype=y.dtype, device=y.device)
        work = dist.reduce_scatter_tensor(out, y, op=_DIST_OPS[op],
                                          group=group, async_op=True)
    else:
        out = y
        work = dist.all_reduce(y, op=_DIST_OPS[op], group=group,
                               async_op=True)

    def finish():
        if widen:
            return _apply_scale(out.to(x.dtype), postscale)
        z = out
        if op == ReduceOp.AVERAGE:
            z = _apply_scale(z, 1.0 / _size(group))
        return _apply_scale(z, postscale)
    return _Pending([work], finish)


def _launch_allreduce(x: torch.Tensor, op: ReduceOp, prescale: float,
                      postscale: float, compression=None,
                      group=None) -> _Pending:
    ctx = None
    if compression is not None:
        x, ctx = compression.compress(x)
    shape = x.shape
    pending = _launch_reduce(x.reshape(-1), op, prescale, postscale,
                             group=group)
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
                    postscale: float, compression=None,
                    group=None) -> _Pending:
    """Allreduce a list of tensors as one fused buffer per dtype (reference:
    ``FuseResponses``, ``controller.cc:686``); Adasum gives each tensor its
    own coefficients, as the JAX package's one ``allreduce_p`` a leaf does
    (``_grouped_allreduce_fn``, ``collectives.py:552-561``)."""
    tensors, ctxs, groups = _grouped_inputs(tensors, compression)
    pendings = [_launch_reduce(torch.cat([tensors[i].reshape(-1)
                                          for i in idxs]),
                               op, prescale, postscale, inplace=True,
                               group=group,
                               sizes=[tensors[i].numel() for i in idxs])
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


def _launch_allgather(x: torch.Tensor, dims: Sequence[int],
                      group=None) -> _Pending:
    """Concatenate every rank's rows (of ``group``); ``dims[r]`` is rank r's
    dim 0. Unequal ranks send padded to the largest and the result is
    trimmed (NCCL's ``all_gather_into_tensor`` takes equal sizes)."""
    x = (x.reshape(1) if x.dim() == 0 else x).contiguous()
    rows, rest = max(dims), tuple(x.shape[1:])
    if x.shape[0] < rows:
        x = torch.cat([x, x.new_zeros((rows - x.shape[0],) + rest)])
    out = torch.empty((len(dims) * rows,) + rest, dtype=x.dtype,
                      device=x.device)
    work = dist.all_gather_into_tensor(out, x, group=group, async_op=True)

    def finish():
        if all(d == rows for d in dims):
            return out
        return torch.cat([out[r * rows:r * rows + d]
                          for r, d in enumerate(dims)])
    return _Pending([work], finish)


def _launch_broadcast(x: torch.Tensor, root_rank: int,
                      inplace: bool = False, group=None) -> _Pending:
    """``root_rank`` is a rank of ``group``."""
    out = x if inplace else x.clone(memory_format=torch.contiguous_format)
    work = dist.broadcast(out, src=_global(group, root_rank), group=group,
                          async_op=True)
    return _Pending([work], lambda: out)


def _launch_alltoall(x: torch.Tensor, send: Optional[Sequence[int]] = None,
                     recv: Optional[Sequence[int]] = None,
                     group=None) -> _Pending:
    """Send ``send[r]`` rows to rank r (of ``group``) and receive
    ``recv[r]`` from it, in rank order; without splits, equal dim-0 parts
    both ways."""
    x = x.contiguous()
    rows = x.shape[0] if recv is None else sum(recv)
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    work = dist.all_to_all_single(
        out, x, output_split_sizes=None if recv is None else list(recv),
        input_split_sizes=None if send is None else list(send),
        group=group, async_op=True)
    return _Pending([work], lambda: out)


# Internal exchanges of the reducers: every rank passes the same shapes, so
# they skip the agreement.

def _allgather_even(x: torch.Tensor, group=None) -> torch.Tensor:
    return _launch_allgather(x, [x.shape[0]] * _size(group), group).wait()


def _alltoall_even(x: torch.Tensor, group=None) -> torch.Tensor:
    return _launch_alltoall(x, group=group).wait()


def _broadcast(x: torch.Tensor, root_rank: int = 0,
               group=None) -> torch.Tensor:
    return _launch_broadcast(x, root_rank, group=group).wait()


# ---------------------------------------------------------------------------
# two mesh axes (JAX: _hierarchical_sum_frame :316, hierarchical_*_p
# :348-433)
# ---------------------------------------------------------------------------

class _Shards:
    """Tensors of a fused buffer, each zero-padded to a multiple of ``n``
    and cut into ``n`` equal parts, laid out as ``[n, width]``: row ``i``
    holds part ``i`` of every tensor, in order. Reduce-scattering the rows
    gives rank ``i`` of the inner axis every tensor's part ``i``, as the
    JAX package's hierarchical reduction of each tensor on its own would
    (so Adasum's outer hop combines each part with its own coefficients).
    One tensor needs no index: its rows are the padded buffer."""

    def __init__(self, sizes: Sequence[int], n: int, device):
        self.count = sum(sizes)
        self.parts = [-(-s // n) for s in sizes]
        self.width = sum(self.parts)
        self.rows_index = self.flat_index = None
        if len(sizes) == 1:
            return
        size = torch.tensor(sizes)
        part = torch.tensor(self.parts)
        src_off = torch.cumsum(size, 0) - size
        col_off = torch.cumsum(part, 0) - part
        seg = torch.repeat_interleave(torch.arange(len(sizes)), part)
        t = torch.arange(self.width) - col_off[seg]
        local = torch.arange(n).unsqueeze(1) * part[seg] + t
        # Padding reads the zero appended after the buffer.
        self.rows_index = torch.where(local < size[seg], src_off[seg] + local,
                                      self.count).reshape(-1).to(device)
        seg = torch.repeat_interleave(torch.arange(len(sizes)), size)
        local = torch.arange(self.count) - src_off[seg]
        self.flat_index = (local // part[seg] * self.width + col_off[seg] +
                           local % part[seg]).to(device)

    def rows(self, flat: torch.Tensor, n: int) -> torch.Tensor:
        """``[n * width]``, row-major."""
        if self.rows_index is None:
            pad = n * self.width - self.count
            return flat if not pad else torch.cat([flat, flat.new_zeros(pad)])
        return torch.cat([flat, flat.new_zeros(1)])[self.rows_index]

    def flat(self, rows: torch.Tensor) -> torch.Tensor:
        if self.flat_index is None:
            return rows[:self.count]
        return rows[self.flat_index]


_SHARDS: Dict[tuple, _Shards] = {}


def _shards(sizes: Sequence[int], n: int, device) -> _Shards:
    key = (tuple(sizes), n, str(device))
    if key not in _SHARDS:
        _SHARDS[key] = _Shards(sizes, n, device)
    return _SHARDS[key]


def _launch_hierarchical(x: torch.Tensor, op: ReduceOp, inner, outer,
                         prescale: float = 1.0, postscale: float = 1.0,
                         sizes: Optional[Sequence[int]] = None) -> _Pending:
    """Reduce-scatter over ``inner``, allreduce the shard over ``outer``
    (Adasum: Adasum over ``outer``, no division after the inner sum), then
    allgather over ``inner``; Min, Max and Product reduce over ``inner``,
    then ``outer``. Average divides by both axes' sizes. Each leg waits on
    the one before it, which on the card orders the streams of the legs'
    communicators without blocking the host. ``sizes``: the tensors fused
    in ``x``, for Adasum's coefficients."""
    gi, go = runtime.group(inner), runtime.group(outer)
    y = _apply_scale(x, prescale)
    if op in (ReduceOp.MIN, ReduceOp.MAX, ReduceOp.PRODUCT):
        first = _launch_reduce(y, op, 1.0, 1.0, inplace=y is not x,
                               group=gi).wait()
        return _launch_reduce(first, op, 1.0, postscale, inplace=True,
                              group=go)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        raise ValueError(f"unknown ReduceOp {op!r}")
    n_in = _size(gi)
    layout = _shards([y.numel()] if sizes is None or op != ReduceOp.ADASUM
                     else sizes, n_in, y.device)
    rows = layout.rows(y.reshape(-1), n_in)
    shard = rows.new_empty(layout.width)
    dist.reduce_scatter_tensor(shard, rows, op=dist.ReduceOp.SUM, group=gi,
                               async_op=True).wait()
    if op == ReduceOp.ADASUM:
        from ..parallel.adasum import adasum
        shard = adasum(shard, group=go, sizes=layout.parts)
    else:
        dist.all_reduce(shard, group=go, async_op=True).wait()
    full = rows.new_empty(n_in * layout.width)
    work = dist.all_gather_into_tensor(full, shard, group=gi, async_op=True)

    def finish():
        out = layout.flat(full).view(x.shape)
        if op == ReduceOp.AVERAGE:
            out = _apply_scale(out, 1.0 / (n_in * _size(go)))
        return _apply_scale(out, postscale)
    return _Pending([work], finish)


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


def _exchange(words: Sequence[int], group=None) -> List[List[int]]:
    """Every rank's row of ``words``, in ``group``'s rank order (one
    allgather on the runtime's device and a copy to the host)."""
    dev = runtime.device()
    n = _size(group)
    mine = torch.tensor(list(words), dtype=torch.int64, device=dev)
    rows = torch.empty(n * mine.numel(), dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(rows, mine, group=group)
    return rows.view(n, -1).tolist()


def _agree(kind: str, shape: Sequence[int], dtype: torch.dtype,
           name: Optional[str] = None, group=None, **kw
           ) -> List[List[int]]:
    """Gather the descriptor of every rank of ``group``, check them, and
    return them."""
    rows = _exchange(_describe(kind, shape, dtype, **kw), group)
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
    def forward(ctx, x, op, prescale, postscale, group):
        ctx.args = (op, prescale, postscale, None, group)
        return _launch_allreduce(x, op, prescale, postscale,
                                 group=group).wait()

    @staticmethod
    def backward(ctx, grad):
        return (_launch_allreduce(grad, *ctx.args).wait(), None, None,
                None, None)


class _AllgatherFn(torch.autograd.Function):
    """An allgather's grad is summed over the ranks, then this rank takes
    its rows."""

    @staticmethod
    def forward(ctx, x, dims, group):
        ctx.shape = x.shape
        ctx.offset = sum(dims[:_rank(group)])
        ctx.group = group
        return _launch_allgather(x, dims, group).wait()

    @staticmethod
    def backward(ctx, grad):
        summed = _launch_allreduce(grad, ReduceOp.SUM, 1.0, 1.0,
                                   group=ctx.group).wait()
        rows = 1 if len(ctx.shape) == 0 else ctx.shape[0]
        return (summed[ctx.offset:ctx.offset + rows].reshape(ctx.shape),
                None, None)


class _BroadcastFn(torch.autograd.Function):
    """A broadcast's grad is summed onto the root; the other ranks get
    zeros."""

    @staticmethod
    def forward(ctx, x, root_rank, group):
        ctx.root_rank = root_rank
        ctx.group = group
        return _launch_broadcast(x, root_rank, group=group).wait()

    @staticmethod
    def backward(ctx, grad):
        summed = _launch_allreduce(grad, ReduceOp.SUM, 1.0, 1.0,
                                   group=ctx.group).wait()
        if _rank(ctx.group) != ctx.root_rank:
            summed = torch.zeros_like(summed)
        return summed, None, None


class _AlltoallFn(torch.autograd.Function):
    """An alltoall's grad routes home: what came from rank r goes back to
    it."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.splits = (send, recv)
        ctx.group = group
        return _launch_alltoall(x, send, recv, group).wait()

    @staticmethod
    def backward(ctx, grad):
        send, recv = ctx.splits
        return (_launch_alltoall(grad, recv, send, ctx.group).wait(), None,
                None, None)


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

def _wire_dtype(x: torch.Tensor, compression) -> torch.dtype:
    if compression is None:
        return x.dtype
    return compression.compress(x.new_empty(0))[0].dtype


def _plan_allreduce(x, op, compression, name, group):
    _agree("allreduce", x.shape, _wire_dtype(x, compression), name, group,
           op=op)


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None, name: Optional[str] = None,
              axis=None) -> torch.Tensor:
    """Allreduce a tensor across ranks, or across the ranks of mesh axis
    ``axis``; Average by default (reference: ``hvd.allreduce``,
    ``horovod/torch/mpi_ops.py:132``). ``compression``
    (``Compression.fp16``/``bf16``) casts the payload for the wire.
    Differentiable."""
    group = runtime.group(axis)
    _plan_allreduce(x, op, compression, name, group)
    if _wants_grad(x):
        if compression is not None:
            wire, ctx = compression.compress(x)
            return compression.decompress(_AllreduceFn.apply(
                wire, op, prescale_factor, postscale_factor, group), ctx)
        return _AllreduceFn.apply(x, op, prescale_factor, postscale_factor,
                                  group)
    return _launch_allreduce(x, op, prescale_factor, postscale_factor,
                             compression, group).wait()


def _plan_grouped(tensors, op, compression, name, group):
    dtypes = [_wire_dtype(t, compression) for t in tensors]
    _agree("allreduce", (sum(t.numel() for t in tensors),),
           dtypes[0] if dtypes else torch.float32, name, group, op=op,
           sig=_group_signature(tensors, dtypes))


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=None, name: Optional[str] = None,
                      axis=None) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused buffer per dtype (reference:
    ``FuseResponses``, ``controller.cc:686``); Adasum combines each tensor
    with its own coefficients."""
    tensors = list(tensors)
    group = runtime.group(axis)
    _plan_grouped(tensors, op, compression, name, group)
    return _launch_grouped(tensors, op, prescale_factor, postscale_factor,
                           compression, group).wait()


def _plan_allgather(x, name, group) -> List[int]:
    rows = _agree("allgather", x.shape, x.dtype, name, group)
    return [r[_DIMS] if r[_NDIM] else 1 for r in rows]


def allgather(x: torch.Tensor, name: Optional[str] = None, axis=None,
              hierarchical: Optional[Sequence[str]] = None
              ) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; ranks may differ in dim
    0 (reference: ``hvd.allgather``, ``mpi_ops.py:238``; a scalar counts as
    one row). ``hierarchical=(inner_axis, outer_axis)`` gathers over the
    inner axis, then the slabs over the outer one
    (:func:`hierarchical_allgather`; JAX ``collectives.py:971-1000``).
    Differentiable, but for the hierarchical form."""
    if hierarchical is not None:
        if len(hierarchical) != 2 or hierarchical[0] == "auto":
            raise ValueError(
                "allgather takes hierarchical=(inner_axis, outer_axis); "
                "the (\"auto\", inner, outer) form applies to "
                "allreduce_gradients/DistributedOptimizer only")
        return hierarchical_allgather(x, *hierarchical, name=name)
    group = runtime.group(axis)
    dims = _plan_allgather(x, name, group)
    if _wants_grad(x):
        return _AllgatherFn.apply(x, dims, group)
    return _launch_allgather(x, dims, group).wait()


def broadcast(x: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None, axis=None) -> torch.Tensor:
    """Return ``root_rank``'s tensor on every rank (reference:
    ``hvd.broadcast``, ``mpi_ops.py:387``); over a mesh axis, the root is
    the axis's rank ``root_rank``. Differentiable."""
    group = runtime.group(axis)
    _agree("broadcast", x.shape, x.dtype, name, group, root=root_rank)
    if _wants_grad(x):
        return _BroadcastFn.apply(x, root_rank, group)
    return _launch_broadcast(x, root_rank, group=group).wait()


def broadcast_(x: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None, axis=None) -> torch.Tensor:
    """In-place broadcast (reference: ``hvd.broadcast_``). A dense tensor
    (``channels_last`` included) is broadcast where it lies."""
    group = runtime.group(axis)
    _agree("broadcast", x.shape, x.dtype, name, group, root=root_rank)
    if x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last)):
        _launch_broadcast(x, root_rank, inplace=True, group=group).wait()
    else:
        x.copy_(_launch_broadcast(x, root_rank, group=group).wait())
    return x


def _splits_list(splits) -> Optional[List[int]]:
    if splits is None:
        return None
    return [int(s) for s in torch.as_tensor(splits).reshape(-1).tolist()]


def _plan_alltoall(x, splits, name, group):
    """The send and receive splits of this rank (None, None when every rank
    sends equal parts of the same dim 0) and the received splits."""
    rows = _agree("alltoall", x.shape, x.dtype, name, group, splits=splits)
    n, me = _size(group), _rank(group)
    if splits is None and all(r[_SPLITS_LEN] < 0 for r in rows) and \
            all(r[_DIMS] == rows[0][_DIMS] for r in rows):
        part = x.shape[0] // n
        return None, None, [part] * n
    if any(r[_SPLITS_LEN] >= 0 for r in rows):
        # Every rank's send vector: rank s sends matrix[s][r] rows to r.
        mine = splits if splits is not None else [x.shape[0] // n] * n
        matrix = _exchange(mine, group)
    else:
        matrix = [[r[_DIMS] // n] * n for r in rows]
    send = list(matrix[me])
    recv = [matrix[s][me] for s in range(n)]
    return send, recv, recv


def alltoall(x: torch.Tensor, splits=None, name: Optional[str] = None,
             axis=None):
    """Send dim-0 parts of ``x`` to every rank and concatenate what each
    rank sent here, in rank order (reference: ``hvd.alltoall``,
    ``operations.cc:1055-1116``). Without ``splits`` the parts are equal and
    the output is returned alone; with ``splits`` (rows to each rank) it
    returns ``(output, received_splits)``, the rows that came from each
    rank as an int32 tensor on the CPU. Differentiable."""
    group = runtime.group(axis)
    splits = _splits_list(splits)
    send, recv, received = _plan_alltoall(x, splits, name, group)
    if _wants_grad(x):
        out = _AlltoallFn.apply(x, send, recv, group)
    else:
        out = _launch_alltoall(x, send, recv, group).wait()
    if splits is None:
        return out
    return out, torch.tensor(received, dtype=torch.int32)


def reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  name: Optional[str] = None, axis=None) -> torch.Tensor:
    """Reduce across ranks (of mesh axis ``axis``) and keep this rank's
    part of dim 0, which the number of ranks divides (reference:
    ``hvd.reducescatter``, ``collectives.py:1032``); Average scales as
    ``allreduce`` does."""
    group = runtime.group(axis)
    _agree("reducescatter", x.shape, x.dtype, name, group, op=op)
    return _launch_reduce(x.contiguous(), op, prescale_factor,
                          postscale_factor, scatter=True,
                          group=group).wait()


def hierarchical_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                           inner_axis: Optional[str] = None,
                           outer_axis: Optional[str] = None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           name: Optional[str] = None) -> torch.Tensor:
    """Allreduce over two mesh axes in three legs: reduce-scatter over the
    fast ``inner_axis`` (NVLink within a node), allreduce the 1/n_inner
    shard over the slow ``outer_axis`` (across nodes), allgather over the
    inner axis (JAX ``hierarchical_allreduce_p``, ``collectives.py:348``;
    reference ``NCCLHierarchicalAllreduce``, ``nccl_operations.cc:204``).
    ``op=Adasum`` sums within the inner axis and runs Adasum across the
    outer one, with no division; Average divides by both sizes; Min, Max
    and Product reduce over the inner axis, then the outer one."""
    if inner_axis is None or outer_axis is None:
        raise ValueError("hierarchical_allreduce needs explicit inner_axis "
                         "and outer_axis")
    _agree("allreduce", x.shape, x.dtype, name,
           runtime.group((inner_axis, outer_axis)), op=op)
    return _launch_hierarchical(x.contiguous(), op, inner_axis, outer_axis,
                                prescale_factor, postscale_factor).wait()


def hierarchical_allgather(x: torch.Tensor, inner_axis: Optional[str] = None,
                           outer_axis: Optional[str] = None,
                           name: Optional[str] = None) -> torch.Tensor:
    """Gather over the fast ``inner_axis``, then the slabs over the slow
    ``outer_axis``: the flat gather's global rank order, since rank
    ``o * n_inner + i`` sits at ``(o, i)`` (JAX
    ``hierarchical_allgather_p``, ``collectives.py:404``; reference
    ``MPIHierarchicalAllgather``, ``mpi_operations.cc:236-240``). Ranks may
    differ in dim 0."""
    if inner_axis is None or outer_axis is None:
        raise ValueError("hierarchical_allgather needs explicit inner_axis "
                         "and outer_axis")
    gi, go = runtime.group(inner_axis), runtime.group(outer_axis)
    slab = _launch_allgather(x, _plan_allgather(x, name, gi), gi).wait()
    return _launch_allgather(slab, _plan_allgather(slab, name, go), go).wait()


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
                    name: Optional[str] = None, axis=None) -> int:
    """Start :func:`allreduce` and return its handle (reference:
    ``allreduce_async``, ``mpi_ops.py:132``)."""
    group = runtime.group(axis)
    _plan_allreduce(x, op, compression, name, group)
    return _register(_launch_allreduce(x, op, prescale_factor,
                                       postscale_factor, compression, group))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: ReduceOp = ReduceOp.AVERAGE,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None,
                            name: Optional[str] = None, axis=None) -> int:
    """Start :func:`grouped_allreduce`; its handle synchronizes to the
    list."""
    tensors = list(tensors)
    group = runtime.group(axis)
    _plan_grouped(tensors, op, compression, name, group)
    return _register(_launch_grouped(tensors, op, prescale_factor,
                                     postscale_factor, compression, group))


def allgather_async(x: torch.Tensor, name: Optional[str] = None,
                    axis=None) -> int:
    """Start :func:`allgather` (the ranks' dim 0 are exchanged first)."""
    group = runtime.group(axis)
    return _register(_launch_allgather(x, _plan_allgather(x, name, group),
                                       group))


def broadcast_async(x: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None, axis=None) -> int:
    group = runtime.group(axis)
    _agree("broadcast", x.shape, x.dtype, name, group, root=root_rank)
    return _register(_launch_broadcast(x, root_rank, group=group))


def alltoall_async(x: torch.Tensor, splits=None,
                   name: Optional[str] = None, axis=None) -> int:
    """Start :func:`alltoall`. As in the reference, its handle
    synchronizes to the output alone, with or without ``splits``."""
    group = runtime.group(axis)
    send, recv, _ = _plan_alltoall(x, _splits_list(splits), name, group)
    return _register(_launch_alltoall(x, send, recv, group))


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
              src: Optional[int] = None, axis=None, group=None
              ) -> Optional[Dict[str, torch.Tensor]]:
    """Send the tensors of ``send`` to rank ``dst`` and receive tensors
    shaped like those of ``recv_like`` from rank ``src``, in one
    ``batch_isend_irecv`` (one rank's part of a ``lax.ppermute``). ``dst``
    and ``src`` are ranks of mesh axis ``axis`` (or of ``group``), every
    rank's by default. Either side may be left out; the tensors go in the
    order of their sorted names. Returns the received tensors, or None."""
    if group is None:
        group = runtime.group(axis)
    ops = []
    if send is not None:
        ops += [dist.P2POp(dist.isend, send[k].contiguous(),
                           _global(group, dst), group)
                for k in sorted(send)]
    received = None
    if recv_like is not None:
        received = {k: torch.empty_like(
                        v, memory_format=torch.contiguous_format)
                    for k, v in recv_like.items()}
        ops += [dist.P2POp(dist.irecv, received[k], _global(group, src),
                           group)
                for k in sorted(received)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return received
