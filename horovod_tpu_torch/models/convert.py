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
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"^(?:(?:Bottleneck)?ResNet)?Block_(\d+)$")
_LAYER = re.compile(r"^(Conv|BatchNorm|RMSNorm|Dense)_(\d+)$")
_PREFIX = {"Conv": "conv", "BatchNorm": "bn", "RMSNorm": "norm",
           "Dense": "fc"}
_NAMED = {"Embed_0": "embed", "Attention_0": "attn"}
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "embedding": "weight"}


def _module_key(key: str, siblings) -> list:
    """The port's name parts for flax module ``key`` among ``siblings``."""
    block = _BLOCK.match(key)
    if block:
        return ["blocks", block.group(1)]
    layer = _LAYER.match(key)
    if layer:
        kind = layer.group(1)
        prefix = _PREFIX[kind]
        alone = sum(1 for k in siblings if k.startswith(kind + "_")) == 1
        return [prefix if alone else f"{prefix}{int(layer.group(2)) + 1}"]
    return [_NAMED.get(key, key)]


def _leaf(name: str, value: np.ndarray) -> torch.Tensor:
    value = np.asarray(value, dtype=np.float32)
    if name == "kernel" and value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
    elif name == "kernel" and value.ndim == 2:
        value = value.T
    # A fresh, writable copy: arrays from JAX are read-only.
    return torch.from_numpy(np.array(value, order="C"))


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert flax ResNet, Transformer or Encoder variables to a
    ``state_dict`` (see module doc)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + _module_key(key, tree))
                continue
            name = "weight" if key == "kernel" else _LEAF[key]
            out[".".join(path + [name])] = _leaf(key, value)

    for collection in ("params", "batch_stats"):
        if collection in variables:
            walk(variables[collection], [])
    return out


def gpt_params_to_torch(params: Mapping, cfg=None,
                        coords: Optional[Mapping[str, Tuple[int, int]]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Convert a JAX GPT parameter tree (nested dicts and lists of arrays)
    to the port's ``state_dict``: ``layers[i]["wq"]`` becomes
    ``layers.i.wq``, each a writable fp32 copy in the same layout.

    Given the port's ``GPTConfig``, the tree is the global one and each
    leaf is cut to a rank's block as ``gpt.param_specs(cfg)`` says: the
    rank at ``coords`` (``{axis: (index, size)}``), this rank by default
    (``parallel.mesh_coords()``)."""
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
    if cfg is None:
        return out
    from ..parallel.axes import local_shard
    from .gpt import param_specs
    specs = param_specs(cfg)
    return {name: local_shard(value, specs[name], coords).contiguous()
            for name, value in out.items()}
