"""Pipeline parallelism: the GPipe schedule over a mesh axis.

Counterpart of ``pipeline_apply`` (``horovod_tpu/parallel/pipeline.py:
25-82``) and ``stage_partition`` (:85). Each rank of the pp axis holds one
stage. For P stages and M micro-batches the schedule runs ``M + P - 1``
ticks; at every tick each rank applies its stage, rank 0 to the next
micro-batch and every other rank to the activation it received, and the
result moves one rank forward (:func:`~horovod_tpu_torch.ops.spmd.
ppermute` with ``perm=[(i, i+1)]``; rank 0 receives zeros). The last stage
stores its outputs, and :func:`~horovod_tpu_torch.ops.spmd.broadcast_p`
gives them to every rank. Autograd of the ticks is the reverse pipeline.

As in the JAX schedule every rank computes at every tick, bubble ticks on
placeholder inputs, and the choices by rank and tick are ``torch.where``
masks: every rank's outputs then depend on every exchange it took part
in, so each rank runs every backward exchange its neighbours wait for.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..ops.spmd import broadcast_p, ppermute
from .axes import axis_index, axis_size


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   axis: str = "pp", broadcast_out: bool = True,
                   remat: bool = False) -> torch.Tensor:
    """Run the shape-preserving ``stage_fn(params, microbatch)`` as a
    GPipe pipeline over ``axis``.

    Args:
      stage_fn: this rank's stage; its output has the micro-batch's shape
        and type.
      stage_params: this rank's stage parameters, a tensor or a pytree of
        them, each with the leading stage dim of size 1 (its block of the
        global ``[P, ...]``), which is squeezed off.
      x: ``[M, mb, ...]`` micro-batches.
      broadcast_out: return the result on every rank of the axis; else it
        is valid on the last stage only.
      remat: recompute each tick's stage in backward
        (``torch.utils.checkpoint``), keeping only the tick's input.

    Returns the last stage's ``[M, mb, ...]`` outputs.
    """
    n, r = axis_size(axis), axis_index(axis)
    M = x.shape[0]
    params = tree_map(lambda p: p.squeeze(0), stage_params)
    perm = [(i, i + 1) for i in range(n - 1)]
    first_rank = torch.tensor(r == 0, device=x.device)
    last_rank = r == n - 1

    act = torch.zeros_like(x[0])
    outs = [torch.zeros_like(x[0]) for _ in range(M)]
    ticks = M + n - 1
    for t in range(ticks):
        inp = torch.where(first_rank, x[min(t, M - 1)], act)
        if remat:
            y = checkpoint(stage_fn, params, inp, use_reentrant=False)
        else:
            y = stage_fn(params, inp)
        m_out = t - (n - 1)
        m = min(max(m_out, 0), M - 1)
        store = torch.tensor(last_rank and m_out >= 0, device=x.device)
        outs[m] = torch.where(store, y, outs[m])
        # The exchange after the last tick would feed no tick: JAX drops
        # its result, and the port skips it on every rank.
        if n > 1 and t < ticks - 1:
            (act,) = ppermute((y,), axis, perm)
    out = torch.stack(outs)
    if broadcast_out and n > 1:
        out = broadcast_p(out, n - 1, axis)
    return out


def stage_partition(n_layers: int, axis_size: int,
                    rank: Optional[int] = None):
    """Contiguous layer ranges per stage: ``(start, count)`` of every rank,
    or of ``rank``."""
    if n_layers % axis_size:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{axis_size} pipeline stages")
    per = n_layers // axis_size
    if rank is None:
        return [(i * per, per) for i in range(axis_size)]
    return rank * per, per
