"""JAX parameter trees -> the port's ``state_dict``.

:func:`gpt_params_to_torch` takes the GPT parameter tree of
``horovod_tpu.models.gpt.init_params``; the port's GPT keeps its names and
layouts, so each leaf is copied under its dotted path.

:func:`flax_to_torch` takes the ``{"params": ..., "batch_stats": ...}``
tree of ``horovod_tpu.models.ResNet`` as nested dicts of numpy arrays
(either collection may be absent, so a gradient tree converts too) and
returns tensors named as in :class:`horovod_tpu_torch.models.resnet.ResNet`:

==================================  ===================================
flax                                port
==================================  ===================================
``conv_init`` / ``bn_init``         ``conv_init`` / ``bn_init``
``{Bottleneck}ResNetBlock_i``       ``blocks.i``
``Conv_j`` / ``BatchNorm_j``        ``conv{j+1}`` / ``bn{j+1}``
``conv_proj`` / ``norm_proj``       ``conv_proj`` / ``norm_proj``
``Dense_0``                         ``fc``
``kernel`` (HWIO conv)              ``weight`` (OIHW)
``kernel`` (in, out dense)          ``weight`` (out, in)
``scale`` / ``bias``                ``weight`` / ``bias``
``mean`` / ``var`` (batch_stats)    ``running_mean`` / ``running_var``
==================================  ===================================
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

_BLOCK = re.compile(r"^(?:Bottleneck)?ResNetBlock_(\d+)$")
_LAYER = re.compile(r"^(Conv|BatchNorm)_(\d+)$")
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _module_name(path) -> str:
    parts = []
    for key in path:
        block = _BLOCK.match(key)
        layer = _LAYER.match(key)
        if block:
            parts += ["blocks", block.group(1)]
        elif layer:
            prefix = "conv" if layer.group(1) == "Conv" else "bn"
            parts.append(f"{prefix}{int(layer.group(2)) + 1}")
        elif key == "Dense_0":
            parts.append("fc")
        else:
            parts.append(key)
    return ".".join(parts)


def _leaf(name: str, value: np.ndarray) -> torch.Tensor:
    value = np.asarray(value, dtype=np.float32)
    if name == "kernel" and value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
    elif name == "kernel":
        value = value.T
    # A fresh, writable copy: arrays from JAX are read-only.
    return torch.from_numpy(np.array(value, order="C"))


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert flax ResNet variables to a ``state_dict`` (see module doc)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            name = "weight" if key == "kernel" else _LEAF[key]
            out[f"{_module_name(path)}.{name}"] = _leaf(key, value)

    for collection in ("params", "batch_stats"):
        if collection in variables:
            walk(variables[collection], ())
    return out


def gpt_params_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a JAX GPT parameter tree (nested dicts and lists of arrays)
    to the port's ``state_dict``: ``layers[i]["wq"]`` becomes
    ``layers.i.wq``, each a writable fp32 copy in the same layout."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        items = (tree.items() if isinstance(tree, Mapping)
                 else enumerate(tree))
        for key, value in items:
            name = f"{prefix}{key}"
            if isinstance(value, (Mapping, Sequence)):
                walk(value, name + ".")
            else:
                out[name] = torch.from_numpy(
                    np.array(value, dtype=np.float32, order="C"))

    walk(params, "")
    return out
