"""Attention building blocks shared by the port's transformer models.

Counterpart of ``default_attention`` (:21) and ``rope`` (:33) in
``horovod_tpu/models/transformer.py``, in the same ``[B, S, H, D]`` layout.
The flax ``Attention``/``Block``/``Transformer`` modules are not ported yet.
"""

from __future__ import annotations

import math

import torch


def default_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Plain softmax attention, softmax in fp32. q/k/v: ``[B, S, H, D]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(qlen, klen, dtype=torch.bool,
                          device=q.device).tril(klen - qlen)
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the two halves of D (not interleaved
    pairs). x: ``[B, S, H, D]``; positions: ``[B, S]``."""
    half = x.shape[-1] // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / (10000.0 ** exponent)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
