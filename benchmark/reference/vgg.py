"""VGG (Simonyan & Zisserman, arXiv:1409.1556; configuration D is
VGG-16), in plain PyTorch.

The arithmetic of the configuration as the benchmark runs it:

* NHWC images in, permuted to NCHW;
* 3x3 convolutions padded by 1, with a bias, each followed by ReLU; ``"M"``
  is a 2x2 max-pool of stride 2;
* the features flattened in (h, w, c) order, then linear 4096, ReLU,
  linear 4096, ReLU, linear to the classes.

torchvision's ``vgg16`` flattens (c, h, w) after an adaptive average pool
that is the identity at 224x224, and puts dropout after the first two
linear layers. The order of the flattened features is a permutation of the
first linear layer's inputs; dropout is left out, as in the measured
program, so a step is a function of its weights and batch alone. The
parameters carry the names of the measured program's model.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv, linear
from .resnet import _Linear


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))


class VGG(nn.Module):
    def __init__(self, cfg: Sequence, num_classes: int, image_size: int,
                 in_channels: int = 3, precision: str = "fp32"):
        super().__init__()
        self.cfg = tuple(cfg)
        self.precision = precision
        widths = [c for c in self.cfg if c != "M"]
        self.convs = [f"conv{i + 1}" for i in range(len(widths))] \
            if len(widths) > 1 else ["conv"]
        channels, size, names = in_channels, image_size, iter(self.convs)
        for item in self.cfg:
            if item == "M":
                size //= 2
                continue
            self.add_module(next(names), _Conv(channels, item))
            channels = item
        self.fc1 = _Linear(size * size * channels, 4096)
        self.fc2 = _Linear(4096, 4096)
        self.fc3 = _Linear(4096, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        p = self.precision
        x = images.permute(0, 3, 1, 2)
        names = iter(self.convs)
        for item in self.cfg:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                layer = getattr(self, next(names))
                x = torch.relu(conv(x, layer.weight, layer.bias, 1, 1, p))
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = torch.relu(linear(x, self.fc1.weight, self.fc1.bias, p))
        x = torch.relu(linear(x, self.fc2.weight, self.fc2.bias, p))
        return linear(x, self.fc3.weight, self.fc3.bias, p).float()


def build(config: dict, precision: str = "fp32") -> VGG:
    """The configuration's model (parameters uninitialized)."""
    arch = config["arch"]
    return VGG(arch["cfg"], arch["num_classes"], arch["image_size"],
               arch["in_channels"], precision)
