"""Collective operations over the ``torch.distributed`` world.

Counterpart of the part of ``horovod_tpu/ops/collectives.py`` this slice
runs: ``ReduceOp`` (:51), ``allreduce`` (:890), ``grouped_allreduce`` (:918),
``allgather`` (:971), ``broadcast`` (:1003) and ``alltoall`` (:1011, even
splits), and :func:`send_recv` for the point-to-point exchanges the JAX
package writes as ``lax.ppermute``. Reference surface:
``horovod/torch/mpi_ops.py``.

Every op is synchronous and returns a new tensor; the input is left as it
was. They run over the process group ``runtime.init`` created (NCCL on the
card, gloo on the CPU).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import runtime


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
# Product of these dtypes is taken in float32 (see _reduce_flat). Integer
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


def _reduce_flat(buf: torch.Tensor, op: ReduceOp, prescale: float,
                 postscale: float) -> torch.Tensor:
    if op not in _DIST_OPS:
        raise NotImplementedError(
            f"{op!r} is not ported yet (Adasum lands with the other "
            "data-parallel variants)")
    y = _apply_scale(buf, prescale)
    if op == ReduceOp.PRODUCT and y.dtype in _WIDENED_PRODUCT:
        # gloo and NCCL multiply 16-bit floats with a rounding at each hop;
        # the reference takes the product in float32 and casts it once.
        wide = y.to(torch.float32)
        dist.all_reduce(wide, op=dist.ReduceOp.PRODUCT)
        return _apply_scale(wide.to(y.dtype), postscale)
    if y is buf:
        y = buf.clone()
    dist.all_reduce(y, op=_DIST_OPS[op])
    if op == ReduceOp.AVERAGE:
        y = _apply_scale(y, 1.0 / runtime.size())
    return _apply_scale(y, postscale)


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None) -> torch.Tensor:
    """Allreduce a tensor across ranks; Average by default (reference:
    ``hvd.allreduce``, ``horovod/torch/mpi_ops.py:132``). ``compression``
    (``Compression.fp16``/``bf16``) casts the payload for the wire."""
    if compression is not None:
        compressed, ctx = compression.compress(x)
        return compression.decompress(
            allreduce(compressed, op, prescale_factor, postscale_factor), ctx)
    out = _reduce_flat(x.reshape(-1), op, prescale_factor, postscale_factor)
    return out.view(x.shape)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=None) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused buffer per dtype (reference:
    ``FuseResponses``, ``controller.cc:686``)."""
    tensors = list(tensors)
    ctxs = [None] * len(tensors)
    if compression is not None:
        pairs = [compression.compress(t) for t in tensors]
        tensors = [p[0] for p in pairs]
        ctxs = [p[1] for p in pairs]
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    outs: List[torch.Tensor] = [None] * len(tensors)
    for idxs in groups.values():
        fused = torch.cat([tensors[i].reshape(-1) for i in idxs])
        red = _reduce_flat(fused, op, prescale_factor, postscale_factor)
        for i, part in zip(idxs, red.split([tensors[i].numel()
                                            for i in idxs])):
            outs[i] = part.view(tensors[i].shape)
    if compression is not None:
        outs = [compression.decompress(o, c) for o, c in zip(outs, ctxs)]
    return outs


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; every rank gives the
    same shape (reference: ``hvd.allgather``, ``mpi_ops.py:238``)."""
    x = x.contiguous()
    out = torch.empty((runtime.size() * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x)
    return out


def broadcast(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Return ``root_rank``'s tensor on every rank (reference:
    ``hvd.broadcast``, ``mpi_ops.py:387``)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=root_rank)
    return out


def broadcast_(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """In-place broadcast (reference: ``hvd.broadcast_``). A dense tensor
    (``channels_last`` included) is broadcast where it lies."""
    if x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last)):
        dist.broadcast(x, src=root_rank)
    else:
        x.copy_(broadcast(x, root_rank))
    return x


def alltoall(x: torch.Tensor) -> torch.Tensor:
    """Scatter equal dim-0 splits to every rank and concatenate what each
    rank sent here, in rank order (reference: ``hvd.alltoall`` with even
    splits)."""
    n = runtime.size()
    if x.shape[0] % n:
        raise ValueError(f"alltoall splits dim 0 evenly: {x.shape[0]} rows "
                         f"over {n} ranks (uneven splits are not ported "
                         "yet)")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out


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
