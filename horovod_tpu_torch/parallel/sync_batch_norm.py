"""Batch normalization over the batch of every rank.

Counterpart of ``horovod_tpu/parallel/sync_batch_norm.py`` (the flax
``SyncBatchNorm``, :40-86) and of the torch frontend's backward
(``horovod_tpu/torch/sync_batch_norm.py:72-95``); reference
``horovod/torch/sync_batch_norm.py``.

:class:`SyncBatchNorm` is :class:`~horovod_tpu_torch.models.resnet.
BatchNorm` (flax's arithmetic, the same parameters and buffers, so a
``state_dict`` carries across both ways) with statistics taken over the
ranks of a mesh axis:

* forward: one fused allreduce (Sum) of ``[Σx, Σx², count]`` a channel, the
  biased variance ``E[x²] - mean²`` and flax's momentum on the old
  statistic, as the JAX module computes them (that variance cancels on
  inputs whose mean is large against their spread; the port keeps the
  JAX module's formula);
* backward (a ``torch.autograd.Function``): one allreduce of
  ``[Σdy, Σdy·x̂]`` a channel, and
  ``dx = w·invstd·(dy - Σdy/N - x̂·Σ(dy·x̂)/N)``, ``N`` the ranks' total
  count; the gradients of weight and bias stay this rank's own, for the
  optimizer to reduce.

The count travels in the reduced tensor, so no statistic comes back to the
host: a step does not wait for the card at any of its batch norms.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .. import runtime
from ..models.resnet import BatchNorm
from ..ops import collectives as C


def _channel_sums(t: torch.Tensor) -> torch.Tensor:
    """Sum over every dim but the channels (dim 1)."""
    return t.sum(dim=[0] + list(range(2, t.dim())))


def _allreduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    return C._launch_reduce(t, C.ReduceOp.SUM, 1.0, 1.0, inplace=True,
                            group=group).wait()


class _SyncBatchNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, group):
        c = x.shape[1]
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.float()
        count = torch.full((1,), x.numel() // c, dtype=torch.float32,
                           device=x.device)
        stats = _allreduce_sum(torch.cat([_channel_sums(xf),
                                          _channel_sums(xf * xf), count]),
                               group)
        n = stats[2 * c:]
        mean = stats[:c] / n
        var = stats[c:2 * c] / n - mean * mean
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean, alpha=1 - momentum)
            running_var.mul_(momentum).add_(var, alpha=1 - momentum)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        return (xhat * weight.view(shape) + bias.view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        shape = [1, c] + [1] * (x.dim() - 2)
        dyf = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        local = torch.cat([_channel_sums(dyf), _channel_sums(dyf * xhat)])
        dbias, dweight = local[:c].clone(), local[c:].clone()
        sums = _allreduce_sum(local, ctx.group)
        dx = (weight * invstd).view(shape) * (
            dyf - (sums[:c] / n).view(shape)
            - xhat * (sums[c:] / n).view(shape))
        return dx.to(x.dtype), dweight, dbias, None, None, None, None, None


class SyncBatchNorm(BatchNorm):
    """``BatchNorm`` whose training statistics span the ranks of mesh axis
    ``axis`` (a name or a tuple of names; the data-parallel axis by default). In eval
    mode it normalizes by the running statistics, as ``BatchNorm`` does."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, zero_scale: bool = False, axis=None):
        super().__init__(num_features, momentum, eps, zero_scale)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        runtime.require_spmd(
            "SyncBatchNorm", "horovod_tpu_torch.torch.SyncBatchNorm (torch "
            "_BatchNorm semantics, statistics through the native core)")
        return _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                      self.running_mean, self.running_var,
                                      self.momentum, self.eps,
                                      runtime.group(self.axis))

    @classmethod
    def convert_sync_batchnorm(cls, module: nn.Module, axis=None
                               ) -> nn.Module:
        """Replace every ``BatchNorm`` under ``module`` by a
        ``SyncBatchNorm`` over ``axis`` that holds the same parameters and
        buffers (the tensors themselves, not copies); returns the module,
        or its replacement if it is a ``BatchNorm`` itself."""
        if isinstance(module, BatchNorm) and not isinstance(module, cls):
            sync = cls(module.weight.shape[0], module.momentum, module.eps,
                       axis=axis)
            sync.weight, sync.bias = module.weight, module.bias
            sync.running_mean = module.running_mean
            sync.running_var = module.running_var
            sync.train(module.training)
            return sync
        for name, child in module.named_children():
            setattr(module, name, cls.convert_sync_batchnorm(child, axis))
        return module

