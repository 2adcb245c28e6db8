"""Cross-replica sharded weight update (ZeRO-1).

Counterpart of ``horovod_tpu/parallel/sharded_optimizer.py`` (its process
path, ``_update_process`` :235-275; technique: "Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training", arXiv:2004.13336).
Instead of allreducing the gradients and running the same update on every
rank, each step

1. flattens the gradients into one fp32 buffer, zero-padded to ``n``
   equal shards (``n`` ranks of the axis), and reduce-scatters it (Sum,
   then ``/ n`` for Average);
2. runs the wrapped ``torch.optim`` optimizer on this rank's shard of the
   flattened parameters, with state for that shard alone;
3. allgathers the updated shards and copies them back into the
   parameters.

The wire carries what one allreduce of the buffer carries (its two
halves), while the optimizer's state and arithmetic drop to 1/n:
:meth:`ShardedDistributedOptimizer.state_bytes` reports the state this rank
holds (the JAX ``publish_optimizer_state_bytes``, :73). The wrapped
optimizer must be elementwise (SGD, momentum, Adam, AdamW, RMSprop, ...):
it sees one flat shard, so a transform across parameters (global-norm
clipping, per-layer scaling) belongs before :meth:`step`.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

from .. import runtime
from ..ops import collectives as C


class ShardedDistributedOptimizer:
    """ZeRO-1 over the ranks of mesh axis ``axis`` (every rank by default).

    Usage::

        opt = hvd.ShardedDistributedOptimizer(torch.optim.Adam,
                                              model.parameters(), lr=1e-3)
        loss.backward()
        opt.step()

    ``optimizer``: a ``torch.optim.Optimizer`` class (or any callable that
    takes a list of parameters and ``**defaults``), built on this rank's
    shard. ``op``: Average (default) or Sum of the ranks' gradients.
    """

    def __init__(self, optimizer, params: Iterable[torch.nn.Parameter],
                 op: C.ReduceOp = C.ReduceOp.AVERAGE, axis=None,
                 **defaults):
        if op not in (C.ReduceOp.AVERAGE, C.ReduceOp.SUM):
            raise ValueError("sharded update supports op=Average or Sum")
        self._op = op
        self._group = runtime.group(axis)
        self._n = C._size(self._group)
        self._params: List[torch.nn.Parameter] = [
            p for p in params if p.requires_grad]
        if not self._params:
            raise ValueError("ShardedDistributedOptimizer got no parameters "
                             "that require grad")
        self._sizes = [p.numel() for p in self._params]
        self._total = sum(self._sizes)
        self.shard_len = -(-self._total // self._n)
        dev = self._params[0].device
        padded = self.shard_len * self._n
        self._grads = torch.zeros(padded, dtype=torch.float32, device=dev)
        self._full = torch.empty(padded, dtype=torch.float32, device=dev)
        self._lo = C._rank(self._group) * self.shard_len
        self.shard = torch.nn.Parameter(
            torch.zeros(self.shard_len, dtype=torch.float32, device=dev))
        self._load_shard()
        self.optimizer = optimizer([self.shard], **defaults)

    def _load_shard(self) -> None:
        """This rank's slice of the flattened parameters, into the shard
        (the parameters may have changed since the last step, as the JAX
        update reads them each call)."""
        hi = min(self._lo + self.shard_len, self._total)
        parts, off = [], 0
        for p, size in zip(self._params, self._sizes):
            a, b = max(self._lo, off), min(hi, off + size)
            if a < b:
                parts.append(p.detach().reshape(-1)[a - off:b - off])
            off += size
        if parts:
            self.shard.data[:hi - self._lo].copy_(torch.cat(parts))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self, closure=None):
        """Reduce-scatter the gradients, update this rank's shard, allgather
        the shards into the parameters. A parameter without a gradient
        contributes zeros, so every rank joins every exchange."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        torch.cat([(p.grad if p.grad is not None else
                    torch.zeros_like(p)).reshape(-1).to(torch.float32)
                   for p in self._params], out=self._grads[:self._total])
        g = C._launch_reduce(self._grads, C.ReduceOp.SUM, 1.0, 1.0,
                             scatter=True, inplace=True,
                             group=self._group).wait()
        if self._op == C.ReduceOp.AVERAGE:
            g.div_(self._n)
        self._load_shard()
        self.shard.grad = g
        self.optimizer.step()
        self.shard.grad = None
        dist.all_gather_into_tensor(self._full, self.shard.detach(),
                                    group=self._group)
        for p, part in zip(self._params,
                           self._full[:self._total].split(self._sizes)):
            p.copy_(part.view_as(p))
        return loss

    def state_bytes(self) -> int:
        """Bytes of the optimizer state this rank holds: every state tensor
        of the wrapped optimizer, each of the shard's length
        (``ceil(n_params / n)`` elements) or a scalar such as Adam's step
        count."""
        return sum(t.numel() * t.element_size()
                   for state in self.optimizer.state.values()
                   for t in state.values() if torch.is_tensor(t))
