"""Mesh-axis introspection shared by the parallel layers and models.

Counterpart of ``horovod_tpu/parallel/axes.py``, answered from the
runtime's mesh: every rank is one process, so an axis of the mesh is always
bound.
"""

from __future__ import annotations

from typing import Optional

from .. import runtime


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
