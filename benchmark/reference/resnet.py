"""ResNet v1.5 (He et al., arXiv:1512.03385; the v1.5 variant strides in
the 3x3 convolution of a bottleneck), in plain PyTorch.

The arithmetic of the configuration as the benchmark runs it:

* NHWC images in, permuted to NCHW;
* a 7x7 stride-2 convolution padded by 3, batch norm, ReLU, and a 3x3
  stride-2 max-pool padded ``SAME`` (the odd pixel high, as in the
  TensorFlow reference of v1.5);
* bottleneck blocks: 1x1, 3x3 (stride 2 in a stage's first block, padded
  ``SAME``), 1x1 with 4x the width, each followed by batch norm, ReLU after
  the first two; a 1x1 projection with batch norm where the shape changes;
  the sum, then ReLU;
* the mean over the positions, then a linear layer to the classes;
* batch norm over (N, H, W) with the batch's own statistics (ε 1e-5), as
  training uses it; convolutions without bias.

torchvision's ``resnet50`` pads its stride-2 windows symmetrically (1, 1);
``SAME`` gives the same output shapes and the same work. The parameters
carry the names of the measured program's model, so the benchmark hands the
same tensor to both sides by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import batch_norm, conv, linear, max_pool_same


def _weight(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.weight = _weight(cout, cin, kernel, kernel)


class _Norm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = _weight(channels)
        self.bias = _weight(channels)


class _Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = _weight(cout, cin)
        self.bias = _weight(cout)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, precision: str):
        super().__init__()
        self.stride = stride
        self.precision = precision
        self.conv1 = _Conv(cin, filters, 1)
        self.bn1 = _Norm(filters)
        self.conv2 = _Conv(filters, filters, 3)
        self.bn2 = _Norm(filters)
        self.conv3 = _Conv(filters, filters * 4, 1)
        self.bn3 = _Norm(filters * 4)
        self.conv_proj = self.norm_proj = None
        if cin != filters * 4 or stride != 1:
            self.conv_proj = _Conv(cin, filters * 4, 1)
            self.norm_proj = _Norm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.precision
        y = torch.relu(batch_norm(conv(x, self.conv1.weight, None, 1, "SAME",
                                       p), self.bn1.weight, self.bn1.bias))
        y = torch.relu(batch_norm(conv(y, self.conv2.weight, None,
                                       self.stride, "SAME", p),
                                  self.bn2.weight, self.bn2.bias))
        y = batch_norm(conv(y, self.conv3.weight, None, 1, "SAME", p),
                       self.bn3.weight, self.bn3.bias)
        shortcut = x
        if self.conv_proj is not None:
            shortcut = batch_norm(
                conv(x, self.conv_proj.weight, None, self.stride, "SAME", p),
                self.norm_proj.weight, self.norm_proj.bias)
        return torch.relu(shortcut + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int,
                 num_filters: int = 64, in_channels: int = 3,
                 precision: str = "fp32"):
        super().__init__()
        self.precision = precision
        self.conv_init = _Conv(in_channels, num_filters, 7)
        self.bn_init = _Norm(num_filters)
        blocks, channels = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2 ** i
                blocks.append(Bottleneck(channels, filters,
                                         2 if i > 0 and j == 0 else 1,
                                         precision))
                channels = filters * Bottleneck.expansion
        self.blocks = nn.Sequential(*blocks)
        self.fc = _Linear(channels, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        p = self.precision
        x = images.permute(0, 3, 1, 2)
        x = torch.relu(batch_norm(conv(x, self.conv_init.weight, None, 2, 3,
                                       p), self.bn_init.weight,
                                  self.bn_init.bias))
        x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return linear(x, self.fc.weight, self.fc.bias, p).float()


def build(config: dict, precision: str = "fp32") -> ResNet:
    """The configuration's model (parameters uninitialized)."""
    arch = config["arch"]
    return ResNet(arch["stage_sizes"], arch["num_classes"],
                  arch["num_filters"], arch["in_channels"], precision)
