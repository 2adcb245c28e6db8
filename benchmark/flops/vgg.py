"""Multiply-adds of a VGG (the layer table of Simonyan & Zisserman,
arXiv:1409.1556, Table 1; configuration D is VGG-16): 3x3 convolutions
padded by 1, 2x2 max-pools, then linear 4096, 4096 and the classes.
torchvision gives VGG-16 15.47 G a 224x224 image."""

from __future__ import annotations


def forward_macs(config: dict) -> int:
    arch = config["arch"]
    size, channels, macs = arch["image_size"], arch["in_channels"], 0
    for item in arch["cfg"]:
        if item == "M":
            size //= 2
            continue
        macs += size * size * 9 * channels * item
        channels = item
    widths = [size * size * channels, 4096, 4096, arch["num_classes"]]
    return macs + sum(a * b for a, b in zip(widths, widths[1:]))
