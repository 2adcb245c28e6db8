"""Multiply-adds of a ResNet v1.5 of bottleneck blocks (the layer table
of He et al., arXiv:1512.03385, Table 1, with the stride in the 3x3
convolution): torchvision gives ResNet-50 4.09 G a 224x224 image."""

from __future__ import annotations


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def forward_macs(config: dict) -> int:
    arch = config["arch"]
    size, cin = arch["image_size"], arch["in_channels"]
    width = arch["num_filters"]
    size = _out(size, 2)                      # 7x7 stride-2 convolution
    macs = size * size * 7 * 7 * cin * width
    size = _out(size, 2)                      # 3x3 stride-2 max-pool
    channels = width
    for i, blocks in enumerate(arch["stage_sizes"]):
        filters = width * 2 ** i
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            out = _out(size, stride)
            macs += size * size * channels * filters          # 1x1
            macs += out * out * 9 * filters * filters         # 3x3
            macs += out * out * filters * filters * 4         # 1x1
            if channels != filters * 4 or stride != 1:
                macs += out * out * channels * filters * 4    # projection
            size, channels = out, filters * 4
    return macs + channels * arch["num_classes"]              # linear
