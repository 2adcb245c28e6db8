"""Compressed allreduce algorithms over the ``torch.distributed`` world.

Counterpart of ``horovod_tpu/compression/reducers.py``: the five reducers
``allgather`` (:91), ``scatter_allgather`` (:102), ``ring`` (:147), ``ps``
(:212) and ``tree`` (:235), the fused-group frame
(``_fuse_leaves``/``_split_leaves``/``_reduce_in_step`` :374-418),
``compressed_allreduce`` (:552), ``compressed_grouped_allreduce`` (:587),
and the hierarchical reduction whose slow hop is compressed,
``hierarchical_compressed_allreduce`` (:313-366).
Reference: ``horovod/common/ops/compressed/reducers/`` (``mpi_allgather.cc``,
``mpi_scatter_allgather.cc``, ``mpi_ring.cc``, ``mpi_ps.cc``,
``mpi_tree.cc``).

Each rank is one process, so a reducer is the JAX package's in-step program
with ``all_gather`` as ``all_gather_into_tensor``, ``all_to_all`` as
``all_to_all_single``, ``ppermute`` as ``batch_isend_irecv``
(:func:`collectives.send_recv`) and ``broadcast_p`` as ``broadcast``, each
through the collectives' unchecked launches: every rank passes the same
shapes, so no descriptor is exchanged. Each runs over the data-parallel
axis, or over another mesh axis's ranks (``axis=``, as the JAX reducers take
``axis=outer_axis``). The
named reducer runs at every world size, one included: then the exchanges
move the payload to this rank itself and the quantize and decode kernels
still run. The reducers take a :class:`MaxMinQuantizer`, a
:class:`NormalizedQuantizer` or a :class:`TopKCompressor`. ``key`` goes
where the JAX package passes it: to the ``allgather`` and ``ps`` uplinks and
the ``tree``; ``scatter_allgather`` and ``ring`` ignore it.

In process mode (``init(mode="process")``) ``compressed_allreduce`` and
``compressed_grouped_allreduce`` take the JAX package's eager process path
(``_eager_process_compressed``, ``reducers.py:514-549``) whatever the
``reduction``: the fused buffer is compressed on this rank (with error
feedback), each payload tensor goes through the native core's allgather as
``car.{i}``, and every rank's payload is decompressed and summed in rank
order in fp32. The named reducers and the hierarchical one run over
``torch.distributed`` groups and raise there.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import runtime
from ..ops import collectives as C
from . import kernels
from .error_feedback import compress_with_feedback
from .quantize import (MaxMinQuantizer, NormalizedQuantizer, QuantContext,
                       TopKCompressor, fold_in)

_COMPRESSORS = (MaxMinQuantizer, NormalizedQuantizer, TopKCompressor)


def _check_compressor(compressor) -> None:
    if not isinstance(compressor, _COMPRESSORS):
        raise TypeError(f"the compressed reducers take a MaxMinQuantizer, "
                        f"NormalizedQuantizer or TopKCompressor, got "
                        f"{compressor!r}")


def _allgather_stacked(payload: Dict[str, torch.Tensor], group
                       ) -> Dict[str, torch.Tensor]:
    """Allgather every payload tensor, stacking a leading ranks dim."""
    return {k: C._allgather_even(v.unsqueeze(0), group)
            for k, v in payload.items()}


def _dequant_sum_stacked(compressor, gathered: Dict[str, torch.Tensor],
                         ctx: QuantContext, n: int) -> torch.Tensor:
    """Sum over the leading ranks dim of the decoded payloads, in fp32.

    Max-min payloads go through the fused dequantize-sum kernel (B3) in one
    pass, which reads every rank's packed codes as they arrived. Any other
    payload is decoded for all ranks at once
    (``decompress_rows``: one B6 launch for the normalized quantizer) and
    added rank by rank in rank order, the JAX package's decode-and-add loop
    (``reducers.py:68-72``)."""
    if isinstance(compressor, MaxMinQuantizer):
        out = kernels.maxmin_dequantize_sum(
            gathered["q"].reshape(n, -1), gathered["min"].reshape(n, -1),
            gathered["unit"].reshape(n, -1), ctx.bits, ctx.bucket_size)
        return out.view(-1)[:ctx.count].view(ctx.shape)
    rows = compressor.decompress_rows(gathered, ctx).to(torch.float32)
    total = torch.zeros(ctx.count, dtype=torch.float32, device=rows.device)
    for r in range(n):
        total = total + rows[r]
    return total.view(ctx.shape)


def _uplink_gather_sum(x, compressor, residual, key, group):
    """Compress locally (with error feedback when a residual is given),
    allgather the payloads, decode and sum; returns the fp32 sum and the new
    residual."""
    if residual is not None:
        payload, ctx, residual = compress_with_feedback(compressor, x,
                                                        residual, key)
    else:
        payload, ctx = compressor.compress(x, key)
    gathered = _allgather_stacked(payload, group)
    return (_dequant_sum_stacked(compressor, gathered, ctx, C._size(group)),
            residual)


def allgather_reducer(x, compressor, residual=None, key=None, axis=None):
    """Compress locally, allgather the payloads, decode and sum all ranks
    (reference: ``reducers/mpi_allgather.cc``)."""
    total, residual = _uplink_gather_sum(x, compressor, residual, key,
                                         runtime.group(axis))
    return total.to(x.dtype), residual


def _padded_chunks(x, residual, n):
    """``x`` (plus ``residual``) in fp32, zero-padded to ``n`` equal
    chunks: ``[n, chunk]``."""
    flat = x.reshape(-1).to(torch.float32)
    count = flat.shape[0]
    chunk = -(-count // n)
    comp_in = torch.zeros(chunk * n, dtype=torch.float32, device=x.device)
    if residual is not None:
        torch.add(flat, residual.reshape(-1).to(torch.float32),
                  out=comp_in[:count])
    else:
        comp_in[:count] = flat
    return comp_in.view(n, chunk)


def _row_residual(compressor, chunks, payload, ctx, x):
    """What compressing each row of ``chunks`` lost, shaped like ``x``."""
    lost = chunks - compressor.decompress_rows(payload, ctx)
    return lost.reshape(-1)[:x.numel()].view(x.shape).to(x.dtype)


def scatter_allgather_reducer(x, compressor, residual=None, key=None,
                              axis=None):
    """Reduce-scatter the compressed chunks, then allgather the compressed
    reduced chunk (reference: ``reducers/mpi_scatter_allgather.cc``).
    ``key`` is ignored, as in the JAX package."""
    group = runtime.group(axis)
    n = C._size(group)
    chunks = _padded_chunks(x, residual, n)
    # One payload row per destination rank.
    row_payload, row_ctx = compressor.compress_rows(chunks)
    if residual is not None:
        residual = _row_residual(compressor, chunks, row_payload, row_ctx, x)

    # Row j goes to rank j; this rank receives every rank's row for its
    # chunk index.
    exchanged = {k: C._alltoall_even(v, group)
                 for k, v in row_payload.items()}
    my_chunk_sum = _dequant_sum_stacked(compressor, exchanged, row_ctx, n)

    # Compress the reduced chunk and allgather it.
    payload2, ctx2 = compressor.compress(my_chunk_sum)
    gathered = _allgather_stacked(payload2, group)
    parts = compressor.decompress_rows(gathered, ctx2)
    out = parts.reshape(-1)[:x.numel()].view(x.shape).to(x.dtype)
    return out, residual


def ring_reducer(x, compressor, residual=None, key=None, axis=None):
    """Ring reduce-scatter, then ring allgather, compressed at every hop
    (reference: ``reducers/mpi_ring.cc``): n-1 hops a phase, so the
    recompression noise grows with the world. Every rank returns rank 0's
    result, as the JAX package's closing ``broadcast_p`` makes it. ``key``
    is ignored, as in the JAX package."""
    group = runtime.group(axis)
    n, idx = C._size(group), C._rank(group)
    chunks = _padded_chunks(x, residual, n)
    ctx = compressor.context((chunks.shape[1],), torch.float32)
    nxt, prev = (idx + 1) % n, (idx - 1) % n
    work = chunks.clone()
    # Reduce-scatter: at step s send chunk (idx - s) compressed, receive
    # chunk (idx - s - 1), decode and add.
    for s in range(n - 1):
        payload, _ = compressor.compress(work[(idx - s) % n])
        received = C.send_recv(payload, nxt, payload, prev, group=group)
        recv_c = (idx - s - 1) % n
        work[recv_c] = work[recv_c] + compressor.decompress(received, ctx)
    # Allgather: the owner of the reduced chunk (idx + 1) compresses it
    # once and each rank forwards what it received.
    current, _ = compressor.compress(work[(idx + 1) % n])
    for s in range(n - 1):
        current = C.send_recv(current, nxt, current, prev, group=group)
        work[(idx - s) % n] = compressor.decompress(current, ctx)
    out = C._broadcast(work.view(-1)[:x.numel()], root_rank=0, group=group)
    if residual is not None:
        # What the first compression of the local chunks lost.
        payload, row_ctx = compressor.compress_rows(chunks)
        residual = _row_residual(compressor, chunks, payload, row_ctx, x)
    return out.view(x.shape).to(x.dtype), residual


def ps_reducer(x, compressor, residual=None, key=None, axis=None):
    """Parameter-server reduction (reference: ``reducers/mpi_ps.cc``): the
    uplink is a compressed allgather, and every rank applies the root's
    downlink quantization of the sum, so the result is bit-identical to the
    root's broadcast."""
    total, residual = _uplink_gather_sum(x, compressor, residual, key,
                                         runtime.group(axis))
    payload2, ctx2 = compressor.compress(total)
    out = compressor.decompress(payload2, ctx2)
    return out.view(x.shape).to(x.dtype), residual


def tree_reducer(x, compressor, residual=None, key=None, axis=None):
    """Binomial-tree reduction (reference: ``reducers/mpi_tree.cc``): at
    round r, ranks that are odd multiples of 2^r compress their accumulator
    and send it to rank - 2^r, which decodes and adds; then rank 0
    compresses the sum and broadcasts the payload. The first uplink is
    compressed under ``key`` and round r > 0 under ``fold_in(key, r)``
    (the JAX package's ``jax.random.fold_in(key, rnd)``)."""
    group = runtime.group(axis)
    n, idx = C._size(group), C._rank(group)
    acc = x.to(torch.float32).clone()
    if residual is not None:
        # Feedback applies to this rank's contribution: both the round-0
        # uplink payload and the local accumulator carry x + residual.
        acc = acc + residual.to(torch.float32).reshape(acc.shape)
        payload, _, residual = compress_with_feedback(compressor, x,
                                                      residual, key)
    else:
        payload, _ = compressor.compress(x, key)
    ctx = compressor.context(acc.shape, torch.float32)
    # Every round's payload, and the root's final one, have the shapes of
    # this first one.
    first = payload
    half, rnd = 1, 0
    while half < n:
        shift = 2 * half
        if idx % shift == half:
            if rnd > 0:
                payload, _ = compressor.compress(
                    acc, None if key is None else fold_in(key, rnd))
            C.send_recv(send=payload, dst=idx - half, group=group)
        elif idx % shift == 0 and idx + half < n:
            received = C.send_recv(recv_like=first, src=idx + half,
                                   group=group)
            acc = acc + compressor.decompress(received, ctx)
        half, rnd = shift, rnd + 1
    # Top-down: the root's compressed sum to everyone.
    if idx == 0:
        final, _ = compressor.compress(acc)
    else:
        final = {k: torch.empty_like(v) for k, v in first.items()}
    final = {k: C._broadcast(v, root_rank=0, group=group)
             for k, v in final.items()}
    out = compressor.decompress(final, ctx)
    return out.view(x.shape).to(x.dtype), residual


_REDUCERS = {
    "allgather": allgather_reducer,
    "scatter_allgather": scatter_allgather_reducer,
    "ring": ring_reducer,
    "ps": ps_reducer,
    "tree": tree_reducer,
}


def _eager_process_compressed(leaves, compressor, op, res_leaves, key,
                              prescale, postscale):
    """Process mode (JAX ``_eager_process_compressed``,
    ``reducers.py:514-549``): fuse the leaves and prescale; compress on
    this rank's device (max-min: B1, and B4 once for the residual); send
    each payload tensor through the core's allgather as ``car.{i}`` (the
    JAX payload's leaf order: sorted keys); decompress every rank's payload
    (max-min: B4 once a rank) and add them in rank order in fp32; divide
    by the world for Average; postscale. Decompressing rank by rank keeps
    the reference's order of rounding, which B3's fused sum does not."""
    n = runtime.size()
    fused = C._apply_scale(_fuse_leaves(leaves), prescale)
    new_res_fused = None
    if res_leaves is not None:
        payload, ctx, new_res_fused = compress_with_feedback(
            compressor, fused, _fuse_leaves(res_leaves), key)
    else:
        payload, ctx = compressor.compress(fused, key)
    keys = sorted(payload)
    gathered = [C.allgather(payload[k].unsqueeze(0), name=f"car.{i}")
                for i, k in enumerate(keys)]
    total = torch.zeros(ctx.shape, dtype=torch.float32, device=fused.device)
    for r in range(n):
        part = {k: g[r] for k, g in zip(keys, gathered)}
        total = total + compressor.decompress(part, ctx).to(torch.float32)
    if op == C.ReduceOp.AVERAGE:
        total = total / n
    total = C._apply_scale(total, postscale)
    outs = _split_leaves(total, leaves)
    new_res = None
    if res_leaves is not None:
        new_res = _split_leaves(new_res_fused.to(torch.float32), res_leaves)
    return outs, new_res


def _check_args(reduction: str, op: C.ReduceOp) -> None:
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


def _reduce_fused(leaves, compressor, reduction, op, res_leaves, key,
                  prescale, postscale, axis=None):
    """Run the named reducer once over the fused buffer of ``leaves``;
    returns (out_leaves, new_res_leaves or None). ``_reduce_in_step`` in the
    JAX package."""
    # The fused buffer, and so every scaled tensor here, is fp32: the
    # dense collectives' scaling is the reference's float32 multiply.
    fused = C._apply_scale(_fuse_leaves(leaves), prescale)
    res_fused = None if res_leaves is None else _fuse_leaves(res_leaves)
    out, new_res = _REDUCERS[reduction](fused, compressor,
                                        residual=res_fused, key=key,
                                        axis=axis)
    if op == C.ReduceOp.AVERAGE:
        n = C._size(runtime.group(axis))
        out = (out.to(torch.float32) / n).to(out.dtype)
    out = C._apply_scale(out, postscale)
    out_leaves = _split_leaves(out.to(torch.float32), leaves)
    new_res_leaves = None
    if res_leaves is not None:
        new_res_leaves = _split_leaves(new_res.to(torch.float32), res_leaves)
    return out_leaves, new_res_leaves


def compressed_allreduce(x: torch.Tensor, compressor,
                         reduction: str = "scatter_allgather",
                         op: C.ReduceOp = C.ReduceOp.AVERAGE,
                         residual: Optional[torch.Tensor] = None,
                         key=None, axis=None):
    """Allreduce with lossy compression on the wire, over the ranks of mesh
    axis ``axis`` (the data-parallel axis by default). ``key`` (an ``int`` seed or a CPU
    ``torch.Generator``) seeds stochastic rounding where the reducer takes
    it.

    Returns ``out``, or ``(out, new_residual)`` when ``residual`` is given.
    """
    _check_args(reduction, op)
    _check_compressor(compressor)
    res_leaves = None if residual is None else [residual]
    if runtime.mode() == "process":
        runtime.group(axis)
        outs, new_res = _eager_process_compressed(
            [x], compressor, op, res_leaves, key, 1.0, 1.0)
    else:
        outs, new_res = _reduce_fused([x], compressor, reduction, op,
                                      res_leaves, key, 1.0, 1.0, axis)
    return outs[0] if residual is None else (outs[0], new_res[0])


def compressed_grouped_allreduce(tensors: Sequence[torch.Tensor], compressor,
                                 reduction: str = "scatter_allgather",
                                 op: C.ReduceOp = C.ReduceOp.AVERAGE,
                                 residuals: Optional[
                                     Sequence[torch.Tensor]] = None,
                                 prescale_factor: float = 1.0,
                                 postscale_factor: float = 1.0, key=None,
                                 axis=None):
    """Compressed allreduce of a list of tensors as ONE fused buffer
    (reference: ``CompressionMode::Fused``, ``common.h:164-168``): the
    tensors are flattened into one fp32 buffer, quantized and reduced once
    (over mesh axis ``axis``, the data-parallel one by default), and split
    back.

    Returns the reduced list, or ``(list, new_residuals)`` when
    ``residuals`` is given.
    """
    _check_args(reduction, op)
    _check_compressor(compressor)
    tensors = list(tensors)
    if not tensors:
        return tensors if residuals is None else (tensors, list(residuals))
    res_leaves = None if residuals is None else list(residuals)
    if runtime.mode() == "process":
        runtime.group(axis)
        outs, new_res = _eager_process_compressed(
            tensors, compressor, op, res_leaves, key, prescale_factor,
            postscale_factor)
    else:
        outs, new_res = _reduce_fused(tensors, compressor, reduction, op,
                                      res_leaves, key, prescale_factor,
                                      postscale_factor, axis)
    return outs if residuals is None else (outs, new_res)


def hierarchical_compressed_residual_zeros(x: torch.Tensor, inner_axis: str
                                           ) -> torch.Tensor:
    """Zeros shaped like the shard whose compressed hop
    :func:`hierarchical_compressed_allreduce` makes (``x`` flattened,
    padded to a multiple of the inner axis's size and scattered over it):
    the error-feedback residual to start with (JAX ``reducers.py:297-311``).
    """
    n_inner = C._size(runtime.group(inner_axis))
    return torch.zeros(-(-x.numel() // n_inner), dtype=x.dtype,
                       device=x.device)


def hierarchical_compressed_allreduce(
        x: torch.Tensor, compressor, inner_axis: Optional[str] = None,
        outer_axis: Optional[str] = None,
        reduction: str = "scatter_allgather",
        op: C.ReduceOp = C.ReduceOp.AVERAGE, residual=None, key=None):
    """Hierarchical allreduce whose slow hop is compressed: a dense
    reduce-scatter over the fast ``inner_axis``, the named compressed
    reducer over the slow ``outer_axis`` on this rank's 1/n_inner shard,
    and a dense allgather over the inner axis (JAX
    ``hierarchical_compressed_allreduce_p``, ``reducers.py:313-366``). The
    fork's gains were on slow inter-node links (SURVEY §2.3): only the
    cross-node hop is quantized, and each rank quantizes only its shard.

    ``residual`` (error feedback) is shard-shaped, state of the compressed
    hop alone: pass ``"init"`` (or ``True``) to start from
    :func:`hierarchical_compressed_residual_zeros`, then the residual the
    previous call returned. Sum and Average only; Average divides by both
    axes' sizes. Returns ``out``, or ``(out, new_residual)`` with a
    residual."""
    runtime.require_spmd("hierarchical_compressed_allreduce")
    if inner_axis is None or outer_axis is None:
        raise ValueError("hierarchical_compressed_allreduce needs explicit "
                         "inner_axis and outer_axis")
    if residual is True or (isinstance(residual, str) and
                            residual == "init"):
        residual = hierarchical_compressed_residual_zeros(x, inner_axis)
    _check_args(reduction, op)
    _check_compressor(compressor)
    gi = runtime.group(inner_axis)
    n_in, n_out = C._size(gi), C._size(runtime.group(outer_axis))
    flat = x.reshape(-1)
    count = flat.numel()
    pad = -count % n_in
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.new_empty(flat.numel() // n_in)
    dist.reduce_scatter_tensor(shard, flat, group=gi,
                                 async_op=True).wait()
    shard, new_res = _REDUCERS[reduction](shard, compressor,
                                          residual=residual, key=key,
                                          axis=outer_axis)
    full = shard.new_empty(shard.numel() * n_in)
    dist.all_gather_into_tensor(full, shard, group=gi)
    y = full[:count].view(x.shape).to(x.dtype)
    if op == C.ReduceOp.AVERAGE:
        y = (y.to(torch.float32) / (n_in * n_out)).to(x.dtype)
    return (y, new_res) if residual is not None else y
