"""Checkpoint save and restore over ``torch.distributed.checkpoint`` (dcp).

Counterpart of ``horovod_tpu/checkpoint.py`` (orbax), held to its rules:

* ``save_checkpoint(path, tree, step=)`` writes a tree (nested dicts,
  lists and tuples of tensors, DTensors and picklable values) under
  ``path/<step>``, atomically: into a temporary sibling, which a rename
  (``os.rename`` on a local disk) then names ``<step>``. A step that
  exists raises;
  ``force=False`` skips a step at or below the latest; ``keep=N`` keeps
  the newest N steps.
* ``restore_checkpoint(path, template=None, step=None)`` restores the
  latest (or given) step. With a template, each tensor is loaded onto its
  template leaf's device, and a DTensor leaf is resharded to the
  template's placements (the counterpart of orbax restoring onto a
  template's shardings); the tree takes the template's structure. Without
  one, tensors come back on the CPU, built from the metadata, in the saved
  structure.
* ``latest_checkpoint_step(path)``: the highest complete step, or None,
  without creating anything.
* ``checkpoint_metadata(path, step=None)``: the saved tree with each
  tensor as a ``device="meta"`` tensor of its shape and dtype (the
  counterpart of ``ShapeDtypeStruct``), read from dcp's metadata file and
  the tree's structure alone, not from the data.

Who writes: a tree of plain tensors is written by rank 0 alone, without a
collective, and the other ranks return (the reference's process mode,
:93-96); a tree holding DTensor leaves is saved collectively by every rank
(each writes its shards). State that differs by rank, such as the
error-feedback residuals in an optimizer's ``state_dict``, goes through
:func:`stack_ranks`: each tensor becomes this rank's row of a DTensor
stacked over every rank (the JAX package's global view of per-rank state,
stacked over the axis on dim 0), and :func:`unstack_rank` takes the rank's
row back out of the restored tree. A step directory holds dcp's files and
``tree.pkl``: the tree's structure with its non-tensor leaves, so that a
restore rebuilds dicts, lists, tuples and scalars as they were saved.
Orbax and dcp checkpoints are not read by each other.

Every path goes through ``fsspec``, a local one on its local filesystem.
A missing path or an empty layout raises ``FileNotFoundError``. A remote
``scheme://`` path that cannot be probed raises a ``RuntimeError`` rather
than let a save create an empty layout (the reference's :45-58). In a
collective save rank 0 alone probes the directory; a step that exists or
a path that cannot be probed raises the same error on every rank.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint._fsspec_filesystem import (FsspecReader,
                                                            FsspecWriter)
from torch.distributed.tensor import DTensor

from . import runtime

TREE_FILE = "tree.pkl"


class _Leaf:
    """A leaf's place in a pickled skeleton: its key."""

    def __init__(self, key: str):
        self.key = key


def _flatten(tree) -> Tuple[Any, Dict[str, Any]]:
    """The skeleton of ``tree`` (its containers, each leaf replaced by a
    :class:`_Leaf`) and its leaves by key: the path's parts joined by
    ``/``."""
    leaves: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            return type(node)((k, walk(v, path + [k]))
                              for k, v in node.items())
        if isinstance(node, (list, tuple)):
            items = [walk(v, path + [i]) for i, v in enumerate(node)]
            if hasattr(node, "_fields"):  # a NamedTuple
                return type(node)(*items)
            return type(node)(items)
        key = "/".join(str(p) for p in path)
        if key in leaves:
            raise ValueError(f"two leaves of the tree are named {key!r}")
        leaves[key] = node
        return _Leaf(key)

    return walk(tree, []), leaves


def _fill(skeleton, values: Dict[str, Any]):
    if isinstance(skeleton, _Leaf):
        return values[skeleton.key]
    if isinstance(skeleton, dict):
        return type(skeleton)((k, _fill(v, values))
                              for k, v in skeleton.items())
    if isinstance(skeleton, (list, tuple)):
        items = [_fill(v, values) for v in skeleton]
        if hasattr(skeleton, "_fields"):
            return type(skeleton)(*items)
        return type(skeleton)(items)
    return skeleton


# ---------------------------------------------------------------------------
# the directory, through fsspec (a local path on its local filesystem,
# whose ``mv`` is ``os.rename`` within one disk)
# ---------------------------------------------------------------------------

def _is_remote(path: str) -> bool:
    return "://" in path


def _resolve(path: str) -> str:
    return path if _is_remote(path) else os.path.abspath(path)


def _fs(path: str):
    import fsspec
    return fsspec.core.url_to_fs(path)[0]


def _exists(path: str) -> bool:
    try:
        return _fs(path).isdir(path)
    except Exception as exc:
        if not _is_remote(path):
            raise
        raise RuntimeError(
            f"cannot probe remote checkpoint path {path!r} "
            f"({type(exc).__name__}: {exc}); refusing to write a checkpoint "
            "layout that could create an empty one there") from exc


def _join(path: str, name) -> str:
    return f"{path.rstrip('/')}/{name}"


def _steps(path: str) -> List[int]:
    """The complete steps under ``path``: directories named by an integer
    (a step's temporary directory is not)."""
    names = [p.rstrip("/").rsplit("/", 1)[-1]
             for p in _fs(path).ls(path, detail=False)]
    return sorted(int(n) for n in names if n.isdigit())


def _remove(path: str) -> None:
    fs = _fs(path)
    if fs.exists(path):
        fs.rm(path, recursive=True)


def _write_tree(directory: str, skeleton, values: Dict[str, Any]) -> None:
    with _fs(directory).open(_join(directory, TREE_FILE), "wb") as f:
        pickle.dump({"skeleton": skeleton, "values": values}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def _read_tree(directory: str) -> Dict[str, Any]:
    with _fs(directory).open(_join(directory, TREE_FILE), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

def _collective(tensors: Dict[str, torch.Tensor]) -> bool:
    return any(isinstance(t, DTensor) for t in tensors.values())


def save_checkpoint(path: str, tree: Any, step: int = 0, force: bool = True,
                    keep: Optional[int] = None) -> bool:
    """Atomically save ``tree`` under ``path/<step>``; returns whether it
    was written.

    A step that exists raises ``FileExistsError`` (orbax's
    ``StepAlreadyExistsError``). ``force=False`` skips a step at or below
    the latest saved one, as orbax's ``should_save`` does. ``keep`` keeps
    only the newest N steps. A tree of plain tensors is written by rank 0
    alone (the other ranks return False); one with DTensor leaves by every
    rank together, each writing its shards."""
    path = _resolve(path)
    skeleton, leaves = _flatten(tree)
    tensors = {k: v.detach() for k, v in leaves.items()
               if isinstance(v, torch.Tensor)}
    values = {k: v for k, v in leaves.items()
              if not isinstance(v, torch.Tensor)}
    collective = _collective(tensors) and runtime.is_initialized()
    if collective:
        runtime.require_spmd("a checkpoint with DTensor leaves")
    writer = not runtime.is_initialized() or runtime.rank() == 0
    if not collective and not writer:
        return False
    final, tmp = _join(path, step), _join(path, f".{step}.tmp")
    outcome = _prepare(path, step, force, tmp) if writer else None
    if collective:
        # Rank 0's outcome, after it made the temporary directory: every
        # rank saves, skips or raises rank 0's error together.
        from .functions import broadcast_object
        outcome = broadcast_object(outcome)
    if isinstance(outcome, BaseException):
        raise outcome
    if outcome == "skip":
        return False
    if collective:
        dcp.save(tensors, storage_writer=FsspecWriter(tmp),
                 process_group=runtime.world_group())
    elif tensors:
        dcp.save(tensors, storage_writer=FsspecWriter(tmp), no_dist=True)
    if writer:
        _write_tree(tmp, skeleton, values)
        _fs(tmp).mv(tmp, final, recursive=True)
        if keep is not None:
            for old in _steps(path)[:-keep] if keep > 0 else _steps(path):
                _remove(_join(path, old))
    if collective:
        dist.barrier(group=runtime.world_group())
    return True


def _prepare(path: str, step: int, force: bool, tmp: str):
    """On the writing rank: ``"skip"``, or ``"save"`` after making the
    empty temporary directory ``tmp``, or the error to raise (a step that
    exists, a path that cannot be probed)."""
    try:
        present = _steps(path) if _exists(path) else []
        if not force and present and present[-1] >= step:
            return "skip"
        if step in present:
            raise FileExistsError(f"checkpoint for step {step} already "
                                  f"exists under {path!r}")
        _remove(tmp)
        _fs(tmp).makedirs(tmp, exist_ok=True)
    except Exception as exc:
        return exc
    return "save"


def stack_ranks(tree):
    """``tree`` with each tensor leaf ``t`` as this rank's row of a
    DTensor ``[world, *t.shape]`` over the runtime's mesh (dim 0 sharded
    over every axis, in rank order), so that a save keeps every rank's
    own value."""
    from torch.distributed.tensor import Shard
    runtime.require_spmd("stack_ranks")
    mesh = runtime.mesh()
    skeleton, leaves = _flatten(tree)
    return _fill(skeleton, {
        k: DTensor.from_local(v.detach().unsqueeze(0), mesh,
                              [Shard(0)] * mesh.ndim, run_check=False)
        if isinstance(v, torch.Tensor) else v for k, v in leaves.items()})


def unstack_rank(tree):
    """Inverse of :func:`stack_ranks` on a restored tree: each tensor leaf
    (a DTensor, or the whole stacked tensor an untemplated restore gives)
    becomes this rank's row."""
    skeleton, leaves = _flatten(tree)
    rank = runtime.rank()
    return _fill(skeleton, {
        k: (v.to_local()[0] if isinstance(v, DTensor) else v[rank])
        if isinstance(v, torch.Tensor) else v for k, v in leaves.items()})


def latest_checkpoint_step(path: str) -> Optional[int]:
    """The highest complete step under ``path``, or None; creates
    nothing."""
    path = _resolve(path)
    if not _exists(path):
        return None
    steps = _steps(path)
    return steps[-1] if steps else None


def _step_dir(path: str, step: Optional[int]) -> str:
    path = _resolve(path)
    if not _exists(path):
        raise FileNotFoundError(f"no checkpoint directory at {path!r}")
    steps = _steps(path)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps under {path!r}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"no checkpoint step {step} under {path!r}")
    return _join(path, step)


def _tensor_metadata(directory: str) -> Dict[str, Tuple[torch.Size,
                                                         torch.dtype]]:
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    try:
        md = FsspecReader(directory).read_metadata()
    except FileNotFoundError:
        return {}  # a tree without tensors has no dcp files
    return {k: (v.size, v.properties.dtype)
            for k, v in md.state_dict_metadata.items()
            if isinstance(v, TensorStorageMetadata)}


def checkpoint_metadata(path: str, step: Optional[int] = None) -> Any:
    """The saved tree of the latest (or given) step, each tensor a
    ``device="meta"`` tensor of its global shape and dtype, the other
    leaves as saved; read without the tensors' data."""
    directory = _step_dir(path, step)
    saved = _read_tree(directory)
    values = dict(saved["values"])
    for key, (size, dtype) in _tensor_metadata(directory).items():
        values[key] = torch.empty(size, dtype=dtype, device="meta")
    return _fill(saved["skeleton"], values)


def _target(leaf: torch.Tensor, size, dtype) -> torch.Tensor:
    """An empty tensor to load a saved tensor into, where ``leaf`` (a
    template's) says: its device (the CPU for a meta tensor) and, for a
    DTensor, its mesh and placements."""
    if isinstance(leaf, DTensor):
        return torch.empty_like(leaf)
    device = "cpu" if leaf.device.type == "meta" else leaf.device
    return torch.empty(size, dtype=dtype, device=device)


def restore_checkpoint(path: str, template: Any = None,
                       step: Optional[int] = None) -> Any:
    """Restore a checkpoint of :func:`save_checkpoint`, the latest step by
    default. ``template``: a tree of the saved structure whose tensor
    leaves say where each tensor goes (its device; a DTensor's mesh and
    placements); the result takes its structure. A template with DTensor
    leaves is restored by every rank together."""
    directory = _step_dir(path, step)
    saved = _read_tree(directory)
    meta = _tensor_metadata(directory)
    if template is None:
        skeleton, targets = saved["skeleton"], {
            k: torch.empty(size, dtype=dtype) for k, (size, dtype)
            in meta.items()}
    else:
        skeleton, leaves = _flatten(template)
        want = set(meta) | set(saved["values"])
        if set(leaves) != want:
            raise ValueError(
                f"the template's leaves {sorted(set(leaves) - want)} are "
                f"not in the checkpoint, and its "
                f"{sorted(want - set(leaves))} not in the template")
        targets = {k: _target(leaves[k], *meta[k]) for k in meta}
    if targets:
        if _collective(targets) and runtime.is_initialized():
            runtime.require_spmd("a checkpoint with DTensor leaves")
            dcp.load(targets, storage_reader=FsspecReader(directory),
                     process_group=runtime.world_group())
        else:
            dcp.load(targets, storage_reader=FsspecReader(directory),
                     no_dist=True)
    return _fill(skeleton, {**saved["values"], **targets})
