"""ResNet v1.5 in PyTorch — the benchmark flagship.

Counterpart of ``horovod_tpu/models/resnet.py`` (flax.linen), with the same
arithmetic so weights converted by :mod:`horovod_tpu_torch.models.convert`
give the same outputs:

* the public input is NHWC, as in the JAX package; the model permutes it to
  NCHW, which for a contiguous NHWC tensor is already ``channels_last``;
* convolutions pad like flax's ``SAME`` (the stride-2 3×3 convolutions and
  the 3×3/2 max-pool pad (0, 1), not (1, 1));
* batch norm follows ``flax.linen.BatchNorm``: momentum 0.9 on the old
  statistic, ε 1e-5, and the running variance takes the biased batch
  variance;
* the last batch-norm scale of each block starts at zero.

On the card, run it under ``torch.autocast("cuda", torch.bfloat16)`` with
fp32 parameters, as the JAX package computes in bf16; logits come back in
fp32.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Type, Union

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0
              ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad ``x`` (NCHW) for a ``SAME`` window op. Symmetric padding is
    returned for the op to apply itself; an asymmetric one is applied here,
    keeping ``x``'s memory format."""
    (ht, hb), (wl, wr) = (_same_pads(x.shape[2], kernel, stride),
                          _same_pads(x.shape[3], kernel, stride))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    x = F.pad(x, (wl, wr, ht, hb), value=value)
    return x.contiguous(memory_format=fmt), (0, 0)


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Conv(nn.Module):
    """``nn.Conv(use_bias=False)`` of flax: ``SAME`` padding unless an
    explicit symmetric ``padding`` is given."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: Union[str, int] = "SAME"):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))
        _lecun_normal_(self.weight, in_channels * kernel * kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            x, pad = _pad_same(x, self.kernel, self.stride)
        else:
            pad = (self.padding, self.padding)
        return F.conv2d(x, self.weight, stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channels of an NCHW tensor.

    ``momentum`` is flax's: the weight of the old running statistic.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        init = torch.zeros if zero_scale else torch.ones
        self.weight = nn.Parameter(init(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # batch_norm updates the statistics it is given in place and saves
        # them for backward, so it gets copies.
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         1.0 - self.momentum, self.eps)
        # PyTorch folds the unbiased batch variance into the running
        # variance and flax the biased one: rescale the folded-in part by
        # (n-1)/n.
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.copy_(mean)
            folded = var.sub(self.running_var, alpha=self.momentum)
            self.running_var.mul_(self.momentum).add_(folded,
                                                      alpha=(n - 1) / n)
        return y


class ResNetBlock(nn.Module):
    """Basic block (ResNet-18/34)."""
    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if in_channels != filters or stride != 1:
            self.conv_proj = Conv(in_channels, filters, 1, stride)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    """Bottleneck block (ResNet-50/101/152)."""
    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if in_channels != filters * 4 or stride != 1:
            self.conv_proj = Conv(in_channels, filters * 4, 1, stride)
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet over NHWC images; returns fp32 logits."""

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[nn.Module], num_classes: int = 1000,
                 num_filters: int = 64, in_channels: int = 3):
        super().__init__()
        self.conv_init = Conv(in_channels, num_filters, 7, 2, padding=3)
        self.bn_init = BatchNorm(num_filters)
        blocks = []
        channels = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(channels, filters, stride))
                channels = filters * block_cls.expansion
        self.blocks = nn.Sequential(*blocks)
        self.fc = nn.Linear(channels, num_classes)
        _lecun_normal_(self.fc.weight, channels)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x, pad = _pad_same(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2, padding=pad)
        x = self.blocks(x)
        x = x.mean(dim=(2, 3))
        return self.fc(x).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)
