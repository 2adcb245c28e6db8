"""Compressed allreduce algorithms over the ``torch.distributed`` world.

Counterpart of ``horovod_tpu/compression/reducers.py``: the
``allgather`` (:91), ``scatter_allgather`` (:102) and ``ps`` (:212)
reducers, the fused-group frame (``_fuse_leaves``/``_split_leaves``/
``_reduce_in_step`` :374-418), ``compressed_allreduce`` (:552) and
``compressed_grouped_allreduce`` (:587). Reference:
``horovod/common/ops/compressed/reducers/`` (``mpi_allgather.cc``,
``mpi_scatter_allgather.cc``, ``mpi_ps.cc``).

Each rank is one process, so a reducer is the JAX package's in-step program
with ``all_gather`` as ``all_gather_into_tensor`` and ``all_to_all`` as
``all_to_all_single``. The named reducer runs at every world size, one
included: then the exchanges move the payload to this rank itself and the
quantize and decode kernels still run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from .. import runtime
from ..ops import collectives as C
from . import kernels
from .error_feedback import compress_with_feedback
from .quantize import MaxMinQuantizer, QuantContext, unpack_bits


def _check_compressor(compressor) -> None:
    if not isinstance(compressor, MaxMinQuantizer):
        raise NotImplementedError(
            f"the compressed reducers take a MaxMinQuantizer; {compressor!r} "
            "is not ported yet")


def _allgather_stacked(payload: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Allgather every payload tensor, stacking a leading ranks dim."""
    return {k: C.allgather(v.unsqueeze(0)) for k, v in payload.items()}


def _dequant_sum_stacked(gathered: Dict[str, torch.Tensor],
                         ctx: QuantContext, n: int) -> torch.Tensor:
    """Sum over the leading ranks dim of the decoded payloads, in one pass
    of the fused dequantize-sum kernel (B3)."""
    padded = -(-ctx.count // ctx.bucket_size) * ctx.bucket_size
    q = unpack_bits(gathered["q"], ctx.bits, padded)
    out = kernels.maxmin_dequantize_sum(
        q.reshape(n, -1, ctx.bucket_size), gathered["min"].reshape(n, -1),
        gathered["unit"].reshape(n, -1))
    return out.view(-1)[:ctx.count].view(ctx.shape)


def _uplink_gather_sum(x, compressor, residual):
    """Compress locally (with error feedback when a residual is given),
    allgather the payloads, decode and sum; returns the fp32 sum and the new
    residual."""
    if residual is not None:
        payload, ctx, residual = compress_with_feedback(compressor, x,
                                                        residual)
    else:
        payload, ctx = compressor.compress(x)
    gathered = _allgather_stacked(payload)
    return _dequant_sum_stacked(gathered, ctx, runtime.size()), residual


def allgather_reducer(x, compressor, residual=None):
    """Compress locally, allgather the payloads, decode and sum all ranks
    (reference: ``reducers/mpi_allgather.cc``)."""
    total, residual = _uplink_gather_sum(x, compressor, residual)
    return total.to(x.dtype), residual


def scatter_allgather_reducer(x, compressor, residual=None):
    """Reduce-scatter the compressed chunks, then allgather the compressed
    reduced chunk (reference: ``reducers/mpi_scatter_allgather.cc``)."""
    n = runtime.size()
    flat = x.reshape(-1).to(torch.float32)
    count = flat.shape[0]
    chunk = -(-count // n)
    comp_in = torch.zeros(chunk * n, dtype=torch.float32, device=x.device)
    if residual is not None:
        torch.add(flat, residual.reshape(-1).to(torch.float32),
                  out=comp_in[:count])
    else:
        comp_in[:count] = flat
    # One payload row per destination rank.
    row_payload, row_ctx = compressor.compress_rows(comp_in.view(n, chunk))
    if residual is not None:
        reconstructed = compressor.decompress_rows(row_payload, row_ctx)
        new_res = (comp_in - reconstructed.reshape(-1))[:count]
        residual = new_res.view(x.shape).to(x.dtype)

    # Row j goes to rank j; this rank receives every rank's row for its
    # chunk index.
    exchanged = {k: C.alltoall(v) for k, v in row_payload.items()}
    my_chunk_sum = _dequant_sum_stacked(exchanged, row_ctx, n)

    # Compress the reduced chunk and allgather it.
    payload2, ctx2 = compressor.compress(my_chunk_sum)
    gathered = _allgather_stacked(payload2)
    parts = compressor.decompress_rows(gathered, ctx2)
    out = parts.reshape(-1)[:count].view(x.shape).to(x.dtype)
    return out, residual


def ps_reducer(x, compressor, residual=None):
    """Parameter-server reduction (reference: ``reducers/mpi_ps.cc``): the
    uplink is a compressed allgather, and every rank applies the root's
    downlink quantization of the sum, so the result is bit-identical to the
    root's broadcast."""
    total, residual = _uplink_gather_sum(x, compressor, residual)
    payload2, ctx2 = compressor.compress(total)
    out = compressor.decompress(payload2, ctx2)
    return out.view(x.shape).to(x.dtype), residual


_REDUCERS = {
    "allgather": allgather_reducer,
    "scatter_allgather": scatter_allgather_reducer,
    "ps": ps_reducer,
}
# Their exchanges are point-to-point chains (batch_isend_irecv); they are
# queued in ROADMAP.md.
_NOT_PORTED = ("ring", "tree")


def _check_args(reduction: str, op: C.ReduceOp) -> None:
    if reduction in _NOT_PORTED:
        raise NotImplementedError(f"the {reduction!r} reducer is not ported "
                                  "yet")
    if reduction not in _REDUCERS:
        raise ValueError(f"unknown reduction {reduction!r}; choose from "
                         f"{sorted(_REDUCERS)}")
    if op not in (C.ReduceOp.SUM, C.ReduceOp.AVERAGE):
        # The compressed reducers are sum-based, like the reference's.
        raise ValueError(f"compressed allreduce supports Sum/Average only, "
                         f"got {op!r}")


def _fuse_leaves(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten and concatenate into one fp32 buffer (the reference's
    fusion-buffer memcpy-in, ``collective_operations.h:51``)."""
    if len(leaves) == 1 and leaves[0].dim() == 1 and \
            leaves[0].dtype == torch.float32:
        return leaves[0]
    return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])


def _split_leaves(flat: torch.Tensor, leaves: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Inverse of :func:`_fuse_leaves` against template ``leaves``."""
    outs, off = [], 0
    for leaf in leaves:
        size = math.prod(leaf.shape)
        outs.append(flat[off:off + size].view(leaf.shape).to(leaf.dtype))
        off += size
    return outs


def _reduce_fused(leaves, compressor, reduction, op, res_leaves, prescale,
                  postscale):
    """Run the named reducer once over the fused buffer of ``leaves``;
    returns (out_leaves, new_res_leaves or None). ``_reduce_in_step`` in the
    JAX package."""
    fused = _fuse_leaves(leaves)
    if prescale != 1.0:
        fused = fused * prescale
    res_fused = None if res_leaves is None else _fuse_leaves(res_leaves)
    out, new_res = _REDUCERS[reduction](fused, compressor,
                                        residual=res_fused)
    if op == C.ReduceOp.AVERAGE:
        out = (out.to(torch.float32) / runtime.size()).to(out.dtype)
    if postscale != 1.0:
        out = (out.to(torch.float32) * postscale).to(out.dtype)
    out_leaves = _split_leaves(out.to(torch.float32), leaves)
    new_res_leaves = None
    if res_leaves is not None:
        new_res_leaves = _split_leaves(new_res.to(torch.float32), res_leaves)
    return out_leaves, new_res_leaves


def compressed_allreduce(x: torch.Tensor, compressor,
                         reduction: str = "scatter_allgather",
                         op: C.ReduceOp = C.ReduceOp.AVERAGE,
                         residual: Optional[torch.Tensor] = None):
    """Allreduce with lossy compression on the wire.

    Returns ``out``, or ``(out, new_residual)`` when ``residual`` is given.
    """
    _check_args(reduction, op)
    _check_compressor(compressor)
    outs, new_res = _reduce_fused(
        [x], compressor, reduction, op,
        None if residual is None else [residual], 1.0, 1.0)
    return outs[0] if residual is None else (outs[0], new_res[0])


def compressed_grouped_allreduce(tensors: Sequence[torch.Tensor], compressor,
                                 reduction: str = "scatter_allgather",
                                 op: C.ReduceOp = C.ReduceOp.AVERAGE,
                                 residuals: Optional[
                                     Sequence[torch.Tensor]] = None,
                                 prescale_factor: float = 1.0,
                                 postscale_factor: float = 1.0):
    """Compressed allreduce of a list of tensors as ONE fused buffer
    (reference: ``CompressionMode::Fused``, ``common.h:164-168``): the
    tensors are flattened into one fp32 buffer, quantized and reduced once,
    and split back.

    Returns the reduced list, or ``(list, new_residuals)`` when
    ``residuals`` is given.
    """
    _check_args(reduction, op)
    _check_compressor(compressor)
    tensors = list(tensors)
    if not tensors:
        return tensors if residuals is None else (tensors, list(residuals))
    outs, new_res = _reduce_fused(
        tensors, compressor, reduction, op,
        None if residuals is None else list(residuals), prescale_factor,
        postscale_factor)
    return outs if residuals is None else (outs, new_res)
