"""VGG (Simonyan & Zisserman, arXiv:1409.1556), the third model of the
reference's published scaling table: VGG-16 has 138,357,544 parameters,
most of them in its fully-connected head, the gradients that gradient
compression exists for.

Counterpart of ``horovod_tpu/models/vgg.py`` (flax.linen), with its
arithmetic:

* the public input is NHWC, permuted to NCHW (``channels_last`` when the
  NHWC tensor is contiguous);
* 3×3 ``SAME`` convolutions with a bias and a ReLU; ``"M"`` is a 2×2
  max-pool of stride 2; then Dense 4096, ReLU, Dense 4096, ReLU, Dense
  classes;
* flax flattens NHWC, ``(h, w, c)``: the head reads the features in that
  order (a view under ``channels_last``), so flax's ``Dense_0`` kernel
  converts without a permutation of its rows;
* lecun-normal kernels and zero biases, as flax initializes them.

flax infers the head's input width at its first call; here it comes from
``image_size``. The layers are ``conv1``… and ``fc1``, ``fc2``, ``fc3``,
the names :func:`~horovod_tpu_torch.models.convert.flax_to_torch` gives
flax's ``Conv_j`` and ``Dense_j``. On the card, run it under
``torch.autocast("cuda", torch.bfloat16)`` with fp32 parameters, as the JAX
package computes in bf16; logits come back in fp32.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mlp import dense, layer_names
from .resnet import Conv

# Conv widths per stage; "M" = 2x2 max-pool (the classic configs).
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(nn.Module):
    """VGG backbone and the 4096-4096-classes head over NHWC images."""

    def __init__(self, cfg: Sequence = VGG16_CFG, num_classes: int = 1000,
                 image_size: int = 224, in_channels: int = 3):
        super().__init__()
        self.cfg = tuple(cfg)
        widths = [item for item in self.cfg if item != "M"]
        self.convs = layer_names("conv", len(widths))
        channels, size = in_channels, image_size
        names = iter(self.convs)
        for item in self.cfg:
            if item == "M":
                size //= 2
                continue
            self.add_module(next(names), Conv(channels, item, 3, bias=True))
            channels = item
        self.fc1 = dense(size * size * channels, 4096)
        self.fc2 = dense(4096, 4096)
        self.fc3 = dense(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        names = iter(self.convs)
        for item in self.cfg:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, next(names))(x))
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x).float()


VGG16 = functools.partial(VGG, cfg=VGG16_CFG)
VGG19 = functools.partial(VGG, cfg=VGG19_CFG)
