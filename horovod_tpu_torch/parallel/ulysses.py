"""Ulysses sequence parallelism: an all-to-all between sequence and heads.

Counterpart of ``horovod_tpu/parallel/ulysses.py`` (``_heads_first`` and
``_seq_first`` :27-35, ``ulysses_attention_p`` :37, ``ulysses_attention``
:69, ``make_ulysses_attention`` :87). q/k/v arrive sequence-sharded
``[B, S/n, H, D]``; one tiled all-to-all each
(:func:`~horovod_tpu_torch.ops.spmd.all_to_all`, whose backward is the
reverse one) makes them head-sharded ``[B, S, H/n, D]``, every rank runs
full-sequence attention over its heads (``attn_fn``: plain attention, or
:func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`, the
``ulysses_flash`` route of kernels B7-B9), and a last all-to-all restores
the sequence sharding. GQA k/v heads are repeated up to the query heads
before the exchange, so query head i keeps its kv group.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.flash_attention import repeat_kv_heads
from ..ops.spmd import all_to_all
from .axes import axis_bound, axis_size
from .ring_attention import _default_axis, _require_axis


def _heads_first(x: torch.Tensor, ax: str) -> torch.Tensor:
    """[B, S/n, H, D] -> [B, S, H/n, D]: scatter heads, gather sequence."""
    return all_to_all(x, ax, split_axis=2, concat_axis=1)


def _seq_first(x: torch.Tensor, ax: str) -> torch.Tensor:
    """[B, S, H/n, D] -> [B, S/n, H, D]: scatter sequence, gather heads."""
    return all_to_all(x, ax, split_axis=1, concat_axis=2)


def ulysses_attention_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, axis: Optional[str] = None,
                        attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Ulysses attention of this rank's sequence shard ``[B, S/n, H, D]``;
    ``H`` must divide by the axis size. ``attn_fn(q, k, v, causal=...)``
    is the full-sequence attention, plain by default."""
    ax = _require_axis(axis, "ulysses_attention_p")
    n = axis_size(ax)
    if q.shape[2] % n:
        raise ValueError(
            f"Ulysses needs heads ({q.shape[2]}) divisible by the "
            f"'{ax}' axis size ({n}); use ring_attention otherwise")
    if attn_fn is None:
        from ..models.transformer import default_attention
        attn_fn = default_attention
    k = repeat_kv_heads(k, q.shape[2])
    v = repeat_kv_heads(v, q.shape[2])
    qh, kh, vh = (_heads_first(t, ax) for t in (q, k, v))
    return _seq_first(attn_fn(qh, kh, vh, causal=causal), ax)


def ulysses_attention(q, k, v, causal: bool = True,
                      axis: Optional[str] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Ulysses attention; as with :func:`~horovod_tpu_torch.parallel.
    ring_attention.ring_attention`, the eager form is the in-step one."""
    return ulysses_attention_p(q, k, v, causal=causal, axis=axis,
                               attn_fn=attn_fn)


def make_ulysses_attention(axis: Optional[str] = None,
                           attn_fn: Optional[Callable] = None) -> Callable:
    """An ``attn_fn`` for :class:`~horovod_tpu_torch.models.Transformer`:
    Ulysses over the axis when the mesh has it, else the inner
    attention."""
    def fn(q, k, v, causal: bool = True):
        ax = _default_axis(axis)
        if axis_bound(ax):
            return ulysses_attention_p(q, k, v, causal=causal, axis=ax,
                                       attn_fn=attn_fn)
        if attn_fn is not None:
            return attn_fn(q, k, v, causal=causal)
        from ..models.transformer import default_attention
        return default_attention(q, k, v, causal=causal)
    return fn
