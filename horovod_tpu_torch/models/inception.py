"""Inception V3 (Szegedy et al., arXiv:1512.00567), the headline model of
the reference's published scaling table (23,834,568 parameters at 1000
classes, without the auxiliary head).

Counterpart of ``horovod_tpu/models/inception.py`` (flax.linen), with its
arithmetic:

* the public input is NHWC, permuted to NCHW (``channels_last`` when the
  NHWC tensor is contiguous);
* ``ConvBN`` is a convolution without a bias, flax's batch norm (momentum
  0.9 on the old statistic, ε 1e-3, the biased batch variance folded into
  the running one) and a ReLU; ``SAME`` padding per spatial dim (the 1×7
  and 7×1 kernels pad one dim only), every stride-2 convolution and
  max-pool ``VALID``;
* the 3×3 average pools of stride 1 are flax's ``SAME`` pools, which count
  the zero padding: ``avg_pool2d(x, 3, 1, 1)``;
* the head averages over the 8×8 grid and applies ``Dense``;
* no auxiliary classifier, as in the JAX package.

Children keep flax's names (``ConvBN_3``, ``InceptionA_0``, …: a kind and
its order of creation within the parent), and a ``ConvBN`` holds ``conv``
and ``bn``, so :func:`~horovod_tpu_torch.models.convert.flax_to_torch`
converts the flax variables name for name (the head's ``Dense_0``, alone
among its siblings, is ``fc``). On the card, run it under
``torch.autocast("cuda", torch.bfloat16)`` with fp32 parameters and batch
statistics, as the JAX package does; logits come back in fp32.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mlp import dense
from .resnet import BatchNorm, Conv


class ConvBN(nn.Module):
    """Conv + BN + ReLU, the basic Inception unit."""

    def __init__(self, in_channels: int, features: int, kernel=3,
                 stride=1, padding: str = "SAME"):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, stride, padding)
        self.bn = BatchNorm(features, momentum=0.9, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class _FlaxNamed(nn.Module):
    """A module whose children are named as flax names them. The branches
    keep their children in plain lists, which register nothing twice."""

    def child(self, kind: str, module: nn.Module) -> nn.Module:
        index = sum(1 for name in self._modules
                    if name.rsplit("_", 1)[0] == kind)
        self.add_module(f"{kind}_{index}", module)
        return module

    def conv_bn(self, *args, **kwargs) -> ConvBN:
        return self.child("ConvBN", ConvBN(*args, **kwargs))


def _run(chain: List[nn.Module], x: torch.Tensor) -> torch.Tensor:
    for module in chain:
        x = module(x)
    return x


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1)


class InceptionA(_FlaxNamed):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        c = self.conv_bn
        self.b1 = [c(in_channels, 64, 1)]
        self.b5 = [c(in_channels, 48, 1), c(48, 64, 5)]
        self.b3 = [c(in_channels, 64, 1), c(64, 96, 3), c(96, 96, 3)]
        self.bp = [c(in_channels, pool_features, 1)]
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_run(self.b1, x), _run(self.b5, x),
                          _run(self.b3, x),
                          _run(self.bp, _avg_pool_same(x))], dim=1)


class InceptionB(_FlaxNamed):
    """Grid-size reduction 35x35 -> 17x17."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = self.conv_bn
        self.b3 = [c(in_channels, 384, 3, 2, "VALID")]
        self.bd = [c(in_channels, 64, 1), c(64, 96, 3),
                   c(96, 96, 3, 2, "VALID")]
        self.out_channels = 384 + 96 + in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_run(self.b3, x), _run(self.bd, x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(_FlaxNamed):
    """Factorized 7x7 branches at 17x17."""

    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c, c7 = self.conv_bn, channels_7x7
        self.b1 = [c(in_channels, 192, 1)]
        self.b7 = [c(in_channels, c7, 1), c(c7, c7, (1, 7)),
                   c(c7, 192, (7, 1))]
        self.bd = [c(in_channels, c7, 1), c(c7, c7, (7, 1)),
                   c(c7, c7, (1, 7)), c(c7, c7, (7, 1)),
                   c(c7, 192, (1, 7))]
        self.bp = [c(in_channels, 192, 1)]
        self.out_channels = 4 * 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_run(self.b1, x), _run(self.b7, x),
                          _run(self.bd, x),
                          _run(self.bp, _avg_pool_same(x))], dim=1)


class InceptionD(_FlaxNamed):
    """Grid-size reduction 17x17 -> 8x8."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = self.conv_bn
        self.b3 = [c(in_channels, 192, 1), c(192, 320, 3, 2, "VALID")]
        self.b7 = [c(in_channels, 192, 1), c(192, 192, (1, 7)),
                   c(192, 192, (7, 1)), c(192, 192, 3, 2, "VALID")]
        self.out_channels = 320 + 192 + in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_run(self.b3, x), _run(self.b7, x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(_FlaxNamed):
    """Expanded-filter-bank blocks at 8x8."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = self.conv_bn
        self.b1 = [c(in_channels, 320, 1)]
        self.b3 = [c(in_channels, 384, 1)]
        self.b3_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.bd = [c(in_channels, 448, 1), c(448, 384, 3)]
        self.bd_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.bp = [c(in_channels, 192, 1)]
        self.out_channels = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3, bd = _run(self.b3, x), _run(self.bd, x)
        return torch.cat([_run(self.b1, x)] +
                         [m(b3) for m in self.b3_split] +
                         [m(bd) for m in self.bd_split] +
                         [_run(self.bp, _avg_pool_same(x))], dim=1)


class InceptionV3(_FlaxNamed):
    """Inception V3 classifier over NHWC images (299x299 canonical; any
    size from 75 works, the head pools globally); fp32 logits."""

    def __init__(self, num_classes: int = 1000, in_channels: int = 3):
        super().__init__()
        c = self.conv_bn
        # Stem: 299 -> 35.
        self.stem = [c(in_channels, 32, 3, 2, "VALID"),
                     c(32, 32, 3, 1, "VALID"), c(32, 64, 3), None,
                     c(64, 80, 1, 1, "VALID"), c(80, 192, 3, 1, "VALID"),
                     None]
        blocks, channels = [], 192
        for kind, cls, args in (
                ("InceptionA", InceptionA, (32,)),
                ("InceptionA", InceptionA, (64,)),
                ("InceptionA", InceptionA, (64,)),
                ("InceptionB", InceptionB, ()),
                ("InceptionC", InceptionC, (128,)),
                ("InceptionC", InceptionC, (160,)),
                ("InceptionC", InceptionC, (160,)),
                ("InceptionC", InceptionC, (192,)),
                ("InceptionD", InceptionD, ()),
                ("InceptionE", InceptionE, ()),
                ("InceptionE", InceptionE, ())):
            block = self.child(kind, cls(channels, *args))
            blocks.append(block)
            channels = block.out_channels
        self.blocks = blocks
        self.fc = dense(channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for unit in self.stem:
            x = F.max_pool2d(x, 3, 2) if unit is None else unit(x)
        x = _run(self.blocks, x)
        x = x.mean(dim=(2, 3))
        return self.fc(x).float()
