"""Mesh-axis introspection shared by the parallel layers and models.

Counterpart of ``horovod_tpu/parallel/axes.py``, answered from the
runtime's mesh: every rank is one process, so an axis of the mesh is always
bound. :func:`axis_index` stands for ``lax.axis_index`` and
:func:`local_shard` for what ``shard_map``'s ``in_specs`` hand each rank.
A spec is a tuple with one entry a leading dim, as a ``PartitionSpec``:
:data:`REPLICATED` and :func:`batch_spec` are ``horovod_tpu/step.py``'s
(:25, :28).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from .. import runtime


REPLICATED: Tuple = ()


def batch_spec(dim: int = 0, axis: Optional[str] = None) -> Tuple:
    """The spec that splits dim ``dim`` over mesh axis ``axis`` (the
    data-parallel axis by default) and keeps every other dim whole."""
    entries: list = [None] * (dim + 1)
    entries[dim] = axis if axis is not None else runtime.dp_axis()
    return tuple(entries)


def axis_size(ax: Optional[str]) -> int:
    """Size of a named mesh axis; 1 when the axis is absent (``None``, or
    not an axis of the mesh) or the runtime is not initialized."""
    if ax is None or not runtime.is_initialized():
        return 1
    return runtime.mesh_shape().get(ax, 1)


def axis_bound(ax: Optional[str]) -> bool:
    """The mesh has an axis of this name. Size-1 axes still need their
    collectives: they run on every rank's device all the same."""
    return ax is not None and runtime.is_initialized() and \
        ax in runtime.axis_names()


def axis_index(ax: Optional[str]) -> int:
    """This rank's coordinate on mesh axis ``ax`` (row-major layout, as
    ``runtime.init`` lays the ranks out); 0 when the axis is not bound."""
    if not axis_bound(ax):
        return 0
    shape = runtime.mesh_shape()
    index = runtime.rank()
    for name in reversed(runtime.axis_names()):
        if name == ax:
            return index % shape[name]
        index //= shape[name]
    raise AssertionError(ax)


def mesh_coords() -> Dict[str, Tuple[int, int]]:
    """``{axis: (this rank's index, axis size)}`` for every mesh axis;
    empty when the runtime is not initialized."""
    if not runtime.is_initialized():
        return {}
    return {ax: (axis_index(ax), n) for ax, n in runtime.mesh_shape().items()}


def local_shard(x: torch.Tensor, spec: Sequence,
                coords: Optional[Mapping[str, Tuple[int, int]]] = None
                ) -> torch.Tensor:
    """A rank's block of the global tensor ``x`` under partition ``spec``
    (one entry a leading dim: None, an axis name or a tuple of axis names,
    the first the slowest, as in a ``PartitionSpec``). ``coords`` gives the
    rank's ``{axis: (index, size)}``, this rank's (:func:`mesh_coords`) by
    default; axes it does not name are ignored."""
    if coords is None:
        coords = mesh_coords()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, index = 1, 0
        for name in names:
            i, n = coords.get(name, (0, 1))
            index, parts = index * n + i, parts * n
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {parts} parts over {names}")
        if parts > 1:
            x = x.chunk(parts, dim)[index]
    return x
