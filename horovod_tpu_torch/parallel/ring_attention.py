"""Ring attention: exact context-parallel attention over a mesh axis.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``
(``_default_axis`` :39, ``_require_axis`` :56, ``ring_attention_p`` :65,
``ring_attention`` :138, ``make_ring_attention`` :168). The sequence is
sharded contiguously over the axis (rank r holds global positions
``r*S .. (r+1)*S-1``); the compact (GQA) k/v blocks and their global
positions go once around the ring through
:func:`~horovod_tpu_torch.ops.spmd.ppermute`, whose backward sends the
gradients the reverse way, and each rank folds every block into the
online-softmax recurrence in fp32. A row masked so far keeps ``-inf``
out of ``exp``, so a fully masked row gives zeros, not NaN. The JAX module
has no Pallas kernel, and this one is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import runtime
from ..ops.flash_attention import repeat_kv_heads
from ..ops.spmd import ppermute
from .axes import axis_bound, axis_index, axis_size

SP_AXIS = "sp"

_NEG_INF = float(np.finfo(np.float32).min)


def _default_axis(axis: Optional[str]) -> Optional[str]:
    """The context-parallel mesh axis: explicit, else the mesh's "sp" axis;
    never the data-parallel one (its ranks hold other batch elements).
    None when no axis applies."""
    if axis is not None:
        return axis
    if runtime.is_initialized() and SP_AXIS in runtime.axis_names():
        return SP_AXIS
    return None


def _require_axis(axis: Optional[str], who: str) -> str:
    ax = _default_axis(axis)
    if ax is None:
        raise ValueError(
            f"{who}: no sequence-parallel mesh axis — pass axis= explicitly "
            f"or init() with a mesh containing an '{SP_AXIS}' axis")
    return ax


def ring_attention_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, axis: Optional[str] = None,
                     q_positions: Optional[torch.Tensor] = None,
                     kv_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Ring attention of this rank's sequence shard. q: ``[B, Sq, H, D]``;
    k, v: ``[B, Sk, Hkv, D]`` with ``Hkv`` dividing ``H``; positions
    ``[Sq]``/``[Sk]`` default to the contiguous layout. Returns
    ``[B, Sq, H, D]`` in q's type."""
    ax = _require_axis(axis, "ring_attention_p")
    n, idx = axis_size(ax), axis_index(ax)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if H % k.shape[2]:
        raise ValueError(
            f"query heads ({H}) not a multiple of kv heads ({k.shape[2]})")
    if q_positions is None:
        q_positions = idx * Sq + torch.arange(Sq, device=q.device)
    if kv_positions is None:
        kv_positions = idx * Sk + torch.arange(Sk, device=q.device)

    q32 = q.to(torch.float32) * (1.0 / math.sqrt(D))
    o_acc = q.new_zeros((B, H, Sq, D), dtype=torch.float32)
    l_acc = q.new_zeros((B, H, Sq), dtype=torch.float32)
    m_acc = q.new_full((B, H, Sq), _NEG_INF, dtype=torch.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]

    for t in range(n):
        kr = repeat_kv_heads(k, H).to(torch.float32)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kr)
        if causal:
            mask = q_positions[:, None] >= kv_positions[None, :]
            logits = torch.where(mask, logits, _NEG_INF)
        new_m = torch.maximum(m_acc, logits.amax(dim=-1))
        safe_m = torch.where(new_m <= _NEG_INF, 0.0, new_m)
        p = torch.exp(logits - safe_m[..., None])
        p = torch.where(logits <= _NEG_INF, 0.0, p)
        corr = torch.where(m_acc <= _NEG_INF, 0.0, torch.exp(m_acc - safe_m))
        l_acc = l_acc * corr + p.sum(dim=-1)
        vr = repeat_kv_heads(v, H).to(torch.float32)
        o_acc = o_acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                       p, vr)
        m_acc = new_m
        if t != n - 1:
            k, v, kv_positions = ppermute((k, v, kv_positions), ax, perm)

    denom = torch.where(l_acc == 0.0, 1.0, l_acc)
    out = o_acc / denom[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(q, k, v, causal: bool = True, axis: Optional[str] = None,
                   q_positions=None, kv_positions=None) -> torch.Tensor:
    """Ring attention. Every rank is a process holding its own shard, so
    the JAX package's eager form (which maps itself over a global array)
    is :func:`ring_attention_p` here."""
    return ring_attention_p(q, k, v, causal=causal, axis=axis,
                            q_positions=q_positions,
                            kv_positions=kv_positions)


def make_ring_attention(axis: Optional[str] = None) -> Callable:
    """An ``attn_fn(q, k, v, causal=True)`` for
    :class:`~horovod_tpu_torch.models.Transformer`: ring attention over the
    axis when the mesh has it, else plain attention."""
    def attn_fn(q, k, v, causal: bool = True):
        ax = _default_axis(axis)
        if axis_bound(ax):
            return ring_attention_p(q, k, v, causal=causal, axis=ax)
        from ..models.transformer import default_attention
        return default_attention(q, k, v, causal=causal)
    return attn_fn
