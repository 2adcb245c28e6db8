"""In-step collectives: the gradients of one SPMD program, rank by rank.

Counterpart of the JAX package's collectives inside ``run_step``, which
maps the step with ``shard_map(check_vma=True)`` (``horovod_tpu/step.py:
38-69``): ``lax.psum`` and ``allreduce_p`` (``ops/collectives.py:154``), the
implicit ``pvary``, ``lax.ppermute``, ``lax.all_to_all(tiled=True)`` and
``alltoall_p`` (:270), and ``broadcast_p`` (:254).

JAX differentiates the whole SPMD program as one function: the transpose of
``psum`` (a varying value made invariant) is the identity on each rank, and
where an invariant value meets a varying one JAX inserts a ``pvary`` whose
transpose is a ``psum``. PyTorch differentiates each rank's program on its
own, so these operators carry those rules in their backward, apart from the
eager collectives of :mod:`~horovod_tpu_torch.ops.collectives`, whose
gradients follow the reference torch binding (the grad of an allreduce is
another allreduce; a broadcast's is summed onto the root):

==============================  ====================  =======================
operator                        forward               backward
==============================  ====================  =======================
``psum(x, axis)``               allreduce Sum         identity
``pvary(x, axis)``              identity              allreduce Sum
``ppermute(xs, axis, perm)``    send/recv by perm     the reverse permutation
``all_to_all(x, axis, s, c)``   tiled all-to-all      the reverse all-to-all
``broadcast_p(x, root, axis)``  broadcast             own grad on the root,
                                                      zeros elsewhere
==============================  ====================  =======================

Two rules for the code that calls them, which JAX needs from no one:

* wrap a value that is the same on every rank of an axis (invariant) with
  :func:`pvary` where it meets a value that differs (varying), e.g. the
  normed activations before a tensor-parallel weight (Megatron's "f");
* every rank's loss must reach the output of every in-step operator it
  called, so that each rank runs the backward exchange the others wait
  for: choose by rank with ``torch.where``, not with a Python branch that
  leaves an output unused.

``axis`` names a mesh axis or a tuple of them (``runtime.group``).
:func:`sum_replica_grads` supplies, after backward, the gradient sums that
JAX's autodiff inserts for parameters replicated over the axes that shard
the data.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import runtime
from . import collectives as C


def _allreduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return C._launch_allreduce(x.contiguous(), C.ReduceOp.SUM, 1.0, 1.0,
                               group=group).wait()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _allreduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _allreduce_sum(grad, ctx.group), None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over the ranks of ``axis``; the gradient passes through as it is
    (``lax.psum`` on a varying value)."""
    return _Psum.apply(x, runtime.group(axis))


def pvary(x: torch.Tensor, axis) -> torch.Tensor:
    """The identity; the gradient is summed over the ranks of ``axis`` (the
    transpose of JAX's implicit ``pvary``)."""
    return _Pvary.apply(x, runtime.group(axis))


def _exchange(tensors: Sequence[torch.Tensor], group, dst, src
              ) -> Tuple[torch.Tensor, ...]:
    """Send ``tensors`` to rank ``dst`` of ``group`` and receive their
    likes from ``src`` (either may be None); zeros where nothing comes."""
    me = dist.get_rank(group)
    if dst == me and src == me:
        return tuple(t.clone() for t in tensors)
    keys = [f"{i:04d}" for i in range(len(tensors))]
    got = C.send_recv(
        send=None if dst is None else dict(zip(keys, tensors)), dst=dst,
        recv_like=None if src is None else dict(zip(keys, tensors)),
        src=src, group=group)
    if got is None:
        return tuple(torch.zeros_like(t) for t in tensors)
    return tuple(got[k] for k in keys)


def _peers(perm: Sequence[Tuple[int, int]], me: int):
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"permutation {list(perm)} sends or receives "
                         f"twice at rank {me}")
    return (dst[0] if dst else None), (src[0] if src else None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perm, *tensors):
        ctx.group = group
        ctx.peers = _peers(perm, dist.get_rank(group))
        ctx.floats = [t.is_floating_point() for t in tensors]
        return _exchange(tensors, group, *ctx.peers)

    @staticmethod
    def backward(ctx, *grads):
        dst, src = ctx.peers
        moving = [g for g, f in zip(grads, ctx.floats) if f]
        back = iter(_exchange(moving, ctx.group, src, dst))
        return (None, None) + tuple(next(back) if f else None
                                    for f in ctx.floats)


def ppermute(tensors: Sequence[torch.Tensor], axis,
             perm: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, ...]:
    """``lax.ppermute``: each ``(src, dst)`` pair of ``perm`` (ranks of
    ``axis``) sends ``src``'s tensors to ``dst``; a rank that no pair
    sends to receives zeros. The gradients travel the reverse way."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _Ppermute.apply(runtime.group(axis), perm, *tensors)


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int
                ) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split into {n} parts")
    parts = x.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
    got = C._alltoall_even(parts.contiguous(), group)
    return got.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: dim ``split_axis`` is cut into n
    parts, part r goes to rank r of ``axis``, and the parts received are
    joined along ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, runtime.group(axis), split_axis, concat_axis)


class _BroadcastP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, root, group):
        ctx.on_root = dist.get_rank(group) == root
        return C._broadcast(x.contiguous(), root, group=group)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.on_root else torch.zeros_like(grad)), None, None


def broadcast_p(x: torch.Tensor, root_rank: int, axis) -> torch.Tensor:
    """The root's ``x`` on every rank of ``axis``. The JAX package writes
    it as a masked psum; one broadcast gives the same values. The gradient
    is each rank's own on the root and zeros elsewhere, unsummed: the
    cotangent of an invariant value is the same on every rank."""
    return _BroadcastP.apply(x, root_rank, runtime.group(axis))


def _replica_axes(spec: Sequence, axes: Iterable[str]) -> Tuple[str, ...]:
    """The axes of ``axes`` that a tensor with partition ``spec`` (one
    entry a dim: None, an axis name or a tuple of them) is not sharded
    over."""
    sharded = set()
    for entry in spec:
        if entry is not None:
            sharded.update((entry,) if isinstance(entry, str) else entry)
    return tuple(a for a in axes if a not in sharded)


def sum_replica_grads(params: Mapping[str, torch.nn.Parameter],
                      specs: Mapping[str, Sequence], axes: Iterable[str]
                      ) -> None:
    """After backward, sum each gradient over the axes of ``axes`` on which
    its parameter is replicated (``specs``: name -> partition), one fused
    allreduce for each set of axes.

    ``axes`` are the mesh axes that shard the data other than dp (sp, and
    ep where the batch rides it): each rank's gradient of a replicated
    parameter there is its tokens' part, as JAX's autodiff sums it. No
    tensor-parallel axis belongs in it: :func:`pvary` made the gradient
    whole on every rank of such an axis already. The average over dp is
    the optimizer's (``DistributedOptimizer(axis=dp)``), after which this
    runs: ``opt.synchronize()``, this, then ``opt.step()`` inside
    ``opt.skip_synchronize()``. The sums and the average commute up to
    rounding."""
    axes = [a for a in axes if a in runtime.axis_names()]
    by_axes: Dict[Tuple[str, ...], list] = {}
    for name, p in params.items():
        over = _replica_axes(specs[name], axes)
        if over and p.requires_grad:
            by_axes.setdefault(over, []).append(p)
    for over, ps in by_axes.items():
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in ps]
        summed = C._launch_grouped(grads, C.ReduceOp.SUM, 1.0, 1.0,
                                   group=runtime.group(over)).wait()
        for p, g in zip(ps, summed):
            p.grad = g
