"""Synchronized batch normalization with ``torch.nn`` semantics: the
statistics of the batch of every rank.

Counterpart of ``horovod_tpu/torch/sync_batch_norm.py`` (the JAX package's
torch frontend, :28-133; reference ``horovod/torch/sync_batch_norm.py:39``),
with the same arithmetic, two-pass so that the variance does not cancel in
float32 (``E[x^2] - mean^2`` loses its precision on activations whose mean
is large against their spread):

* pass 1: a Sum allreduce of ``[Σx, count]`` (fp32 channel sums, the
  count in the last slot) gives the mean;
* pass 2: a Sum allreduce of ``Σ(x - mean)^2`` gives the variance; the
  running variance takes the unbiased one, ``momentum`` weighs the new
  statistic (``None``: a cumulative average over ``num_batches_tracked``);
* backward: one Sum allreduce of ``[Σdy, Σdy·(x - mean)]`` and
  ``dx = w·invstd·(dy - mean(dy) - (x - mean)·invstd²·mean(dy·(x - mean)))``
  over the ranks' whole batch; the gradients of weight and bias stay this
  rank's own, for the optimizer to reduce.

In process mode the three exchanges go through the native core, under the
JAX frontend's names; in SPMD mode through the data-parallel axis's process
group. In eval mode, and on a single rank, it is torch's own batch norm.
Unlike the JAX frontend it runs on the rank's device (the core's exchanges
are staged through pinned host memory); the total count comes back to the
host once a layer (``.item()``), as there.

This is the class of ``horovod_tpu_torch.torch``; the package's top-level
``SyncBatchNorm`` (``parallel/sync_batch_norm.py``) is the flax module's
counterpart.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm

from .. import runtime
from ..ops import collectives as C


def _channel_sums(t: torch.Tensor) -> torch.Tensor:
    """Sum over every dim except channel (dim 1)."""
    dims = [0] + list(range(2, t.dim()))
    return t.sum(dim=dims)


def _group():
    """The ranks the statistics span: every rank in process mode, the
    data-parallel axis in SPMD mode."""
    return None if runtime.mode() == "process" else runtime.group(None)


def _allreduce_sum(t: torch.Tensor, name: str) -> torch.Tensor:
    if runtime.mode() == "process":
        return C._core_collective("allreduce", t, name,
                                  op=int(C.ReduceOp.SUM), prescale=1.0,
                                  postscale=1.0)
    return C._launch_reduce(t.contiguous(), C.ReduceOp.SUM, 1.0, 1.0,
                            inplace=True, group=_group()).wait()


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var,
                eps, momentum):
        c = input.size(1)
        count_local = input.numel() // c
        x32 = input.float()

        stats = torch.empty(c + 1, dtype=torch.float32, device=input.device)
        stats[:c] = _channel_sums(x32)
        stats[c] = float(count_local)
        stats = _allreduce_sum(stats, "sync_batch_norm.mean")
        count = stats[c].item()
        mean = (stats[:c] / count).to(input.dtype)

        shape = [1, c] + [1] * (input.dim() - 2)
        xmu32 = x32 - mean.float().view(shape)
        sqsum = _allreduce_sum(_channel_sums(xmu32 * xmu32),
                               "sync_batch_norm.var")
        var = (sqsum / count).clamp(min=0.0).to(input.dtype)
        invstd = torch.rsqrt(var + eps)

        if running_mean is not None:
            unbiased = var * (count / max(count - 1, 1))
            running_mean.mul_(1 - momentum).add_(mean.detach(),
                                                 alpha=momentum)
            running_var.mul_(1 - momentum).add_(unbiased.detach(),
                                                alpha=momentum)

        xhat = (input - mean.view(shape)) * invstd.view(shape)
        out = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(input, weight, mean, invstd)
        ctx.count = count
        return out

    @staticmethod
    def backward(ctx, grad_out):
        input, weight, mean, invstd = ctx.saved_tensors
        c = input.size(1)
        shape = [1, c] + [1] * (input.dim() - 2)
        xmu = input - mean.view(shape)

        sums = torch.empty(2 * c, dtype=torch.float32, device=input.device)
        sums[:c] = _channel_sums(grad_out.float())
        sums[c:] = _channel_sums(grad_out.float() * xmu.float())
        sums = _allreduce_sum(sums, "sync_batch_norm.grad")
        mean_dy = (sums[:c] / ctx.count).to(input.dtype)
        mean_dy_xmu = (sums[c:] / ctx.count).to(input.dtype)

        dx = (weight.view(shape) * invstd.view(shape)) * (
            grad_out - mean_dy.view(shape)
            - xmu * (invstd * invstd * mean_dy_xmu).view(shape))
        # Local weight/bias grads; the optimizer's allreduce averages them.
        dweight = _channel_sums(grad_out * xmu * invstd.view(shape))
        dbias = _channel_sums(grad_out)
        return dx, dweight, dbias, None, None, None, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in ``torch.nn.BatchNorm*`` whose training statistics span the
    ranks (reference: ``hvd.SyncBatchNorm``, torch/sync_batch_norm.py:39;
    JAX ``horovod_tpu.torch.SyncBatchNorm``). Plain batch norm in eval
    mode and on a single rank, like the reference (:64-67)."""

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(input)
        if not self.training or C._size(_group()) == 1:
            return super().forward(input)

        if self.num_batches_tracked is not None:
            self.num_batches_tracked += 1
        if self.momentum is None:
            # Cumulative moving average needs the tracked count; without
            # track_running_stats there are no running stats to update.
            momentum = (1.0 / float(self.num_batches_tracked)
                        if self.num_batches_tracked is not None else 0.0)
        else:
            momentum = self.momentum

        weight = self.weight if self.affine else \
            torch.ones(self.num_features, dtype=input.dtype,
                       device=input.device)
        bias = self.bias if self.affine else \
            torch.zeros(self.num_features, dtype=input.dtype,
                        device=input.device)
        running_mean = self.running_mean if self.track_running_stats else None
        running_var = self.running_var if self.track_running_stats else None
        return _SyncBatchNormFn.apply(input, weight, bias, running_mean,
                                      running_var, self.eps, momentum)


def convert_sync_batchnorm(module: nn.Module) -> nn.Module:
    """A helper of the port (the JAX class has none): replace every batch
    norm under ``module`` (``torch.nn``'s, or the port models' flax-style
    ``BatchNorm``, whose ``momentum`` m weighs the old statistic and becomes
    1 - m here) by a :class:`SyncBatchNorm` that holds the same parameters
    and running statistics (the tensors themselves). Returns the module, or
    its replacement if it is a batch norm itself."""
    from ..models.resnet import BatchNorm
    if isinstance(module, SyncBatchNorm):
        return module
    if isinstance(module, (_BatchNorm, BatchNorm)):
        flax = isinstance(module, BatchNorm)
        sync = SyncBatchNorm(
            module.weight.shape[0] if flax else module.num_features,
            eps=module.eps,
            momentum=1.0 - module.momentum if flax else module.momentum,
            affine=flax or module.affine,
            track_running_stats=flax or module.track_running_stats)
        where = next(module.buffers(), next(module.parameters(), None))
        if where is not None:
            sync.to(where.device)
        if sync.affine:
            sync.weight, sync.bias = module.weight, module.bias
        if sync.track_running_stats:
            sync.running_mean = module.running_mean
            sync.running_var = module.running_var
            if not flax:
                sync.num_batches_tracked = module.num_batches_tracked
        sync.train(module.training)
        return sync
    for name, child in module.named_children():
        setattr(module, name, convert_sync_batchnorm(child))
    return module
