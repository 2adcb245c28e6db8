"""What a run feeds both sides, made from ``--seed``: the initial weights
and every rank's batch of every step.

Weights are drawn on the device in one call of a seeded generator and
handed out in the reference's parameter order, each scaled by its rule:
a convolution's by ``kaiming_fan_out`` (std ``sqrt(2 / fan_out)``, as
torchvision initializes both models), a linear layer's by the
configuration's rule, a 1-D ``bias`` 0 and any other 1-D tensor (a batch
norm's scale) 1. A batch is NHWC float32 images from a unit normal and
labels uniform over the classes: a checked step's from a generator seeded
by (seed, rank, step), so the reference draws the same ones in any
process; the later steps' from one generator a rank (:class:`Feed`).
Every step of every rank sees rows of its own, and the same seed gives the
same batches.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterable, Tuple

import torch


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed of its own for ``parts`` under ``seed`` (any whole
    number, negative or wider than 64 bits included)."""
    digest = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


_STD: Dict[str, Callable[[Tuple[int, ...]], float]] = {
    "kaiming_fan_out": lambda s: math.sqrt(2.0 / (s[0] * math.prod(s[2:]))),
    # torch's nn.Linear default: uniform on +-1/sqrt(fan_in), whose std
    # this is.
    "torch_linear": lambda s: 1.0 / math.sqrt(3.0 * s[1]),
}


def _std(rule, shape) -> float:
    return float(rule) if isinstance(rule, (int, float)) else \
        _STD[rule](tuple(shape))


def weights(named: Iterable[Tuple[str, torch.Size]], init: dict, seed: int,
            device) -> Dict[str, torch.Tensor]:
    """float32 weights by name: ``named`` the (name, shape) of every
    parameter in a fixed order; ``init`` the configuration's rules for
    ``conv`` (4-D) and ``linear`` (2-D) weights."""
    named = list(named)
    drawn = [(n, s) for n, s in named if len(s) > 1]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                             "weights"))
    flat = torch.randn(sum(math.prod(s) for _, s in drawn), generator=gen,
                       device=device)
    out, offset = {}, 0
    for name, shape in named:
        if len(shape) > 1:
            size = math.prod(shape)
            rule = init["conv"] if len(shape) == 4 else init["linear"]
            out[name] = flat[offset:offset + size].view(shape).mul_(
                _std(rule, shape))
            offset += size
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def _draw(config: dict, gen: torch.Generator, device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    arch = config["arch"]
    size, n = arch["image_size"], config["batch_per_chip"]
    images = torch.randn(n, size, size, arch["in_channels"], generator=gen,
                         device=device)
    labels = torch.randint(0, arch["num_classes"], (n,), generator=gen,
                           device=device)
    return images, labels


def batch(config: dict, seed: int, rank: int, step: int, device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s batch at checked step ``step``: ``batch_per_chip``
    NHWC images and their labels."""
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "batch", rank, step))
    return _draw(config, gen, device)


class Feed:
    """A rank's batches after the checked steps, a new one every step, drawn
    on the device from one generator of (seed, rank): the steps the window
    times see new rows each, as a training job's input does, and cannot
    memorize a few batches."""

    def __init__(self, config: dict, seed: int, rank: int, device):
        self.config, self.device = config, device
        self.gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "feed", rank))

    def __call__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return _draw(self.config, self.gen, self.device)
