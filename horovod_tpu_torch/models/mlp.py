"""MNIST-scale MLP, the smallest end-to-end model.

Counterpart of ``horovod_tpu/models/mlp.py`` (flax.linen): the input is
flattened per example, each width but the last is a ``Dense`` and a ReLU,
the last ``Dense`` gives the logits. flax infers the input width at its
first call; here it is ``in_features``. The layers are ``fc1``, ``fc2``, …
(``fc`` alone when there is one), the names
:func:`~horovod_tpu_torch.models.convert.flax_to_torch` gives flax's
``Dense_j``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import _lecun_normal_


def dense(in_features: int, out_features: int) -> nn.Linear:
    """flax's ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    _lecun_normal_(layer.weight, in_features)
    nn.init.zeros_(layer.bias)
    return layer


def layer_names(prefix: str, count: int):
    """The port's names of ``count`` flax layers ``Kind_0``… of one
    module: ``prefix`` alone for one, else ``prefix1``…"""
    return [prefix] if count == 1 else [f"{prefix}{i + 1}"
                                        for i in range(count)]


class MLP(nn.Module):
    def __init__(self, features: Sequence[int] = (128, 64, 10),
                 in_features: int = 784):
        super().__init__()
        self.names = layer_names("fc", len(features))
        widths = [in_features, *features]
        for name, n_in, n_out in zip(self.names, widths, widths[1:]):
            self.add_module(name, dense(n_in, n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for name in self.names[:-1]:
            x = F.relu(getattr(self, name)(x))
        return getattr(self, self.names[-1])(x)
