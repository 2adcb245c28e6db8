"""The decoder-only Transformer and its building blocks.

Counterpart of ``horovod_tpu/models/transformer.py``: ``default_attention``
(:21) and ``rope`` (:33) in the same ``[B, S, H, D]`` layout, and the flax
modules ``Attention`` (:45), ``Block`` (:69) and ``Transformer`` (:89) with
their numerics: fp32 parameters cast to ``dtype`` at each use (flax's
``promote_dtype``), biases on every projection, RMSNorm's statistics in
fp32 with ``x * (rsqrt(var + 1e-6) * scale)``, the tanh GELU. ``attn_fn``
swaps the attention as in JAX: plain, the fused kernels
(:func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`), ring or
Ulysses (``parallel.make_ring_attention``/``make_ulysses_attention``).

Module and parameter names follow flax's, so that
:func:`~horovod_tpu_torch.models.convert.flax_to_torch` loads
``model.init``'s variables: ``Embed_0`` is ``embed``, ``Block_i``
``blocks.i``, ``Attention_0`` ``attn`` (``q``, ``k``, ``v``, ``o``, each
kernel in flax's layout), ``RMSNorm_j`` ``norm{j+1}`` and ``Dense_j``
``fc{j+1}`` (``norm`` and ``fc`` where a module has one of them).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


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


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm`` (epsilon 1e-6, fp32 statistics)."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return (x32 * (torch.rsqrt(var + 1e-6) * self.weight)).to(self.dtype)


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` over the trailing ``len(in_shape)`` dims:
    ``weight`` is ``[*in_shape, *out_shape]`` (flax's kernel layout),
    ``bias`` ``[*out_shape]``."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        fan_in = math.prod(in_shape)
        self.weight = nn.Parameter(torch.randn(*in_shape, *out_shape) /
                                   math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = self.weight.dim() - self.bias.dim()
        y = torch.tensordot(x.to(self.dtype), self.weight.to(self.dtype),
                            dims=n_in)
        return y + self.bias.to(self.dtype)


class Attention(nn.Module):
    """flax ``Attention``: q/k/v projections to ``[B, S, H, D]``, RoPE,
    ``attn_fn``, the output projection."""

    def __init__(self, embed_dim: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Callable = default_attention, causal: bool = True):
        super().__init__()
        self.attn_fn, self.causal = attn_fn, causal
        heads = (num_heads, head_dim)
        self.q = DenseGeneral((embed_dim,), heads, dtype)
        self.k = DenseGeneral((embed_dim,), heads, dtype)
        self.v = DenseGeneral((embed_dim,), heads, dtype)
        self.o = DenseGeneral(heads, (embed_dim,), dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        q = rope(self.q(x), positions)
        k = rope(self.k(x), positions)
        out = self.attn_fn(q, k, self.v(x), causal=self.causal)
        return self.o(out)


def _dense(in_features: int, out_features: int) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    nn.init.normal_(layer.weight, std=1.0 / math.sqrt(in_features))
    nn.init.zeros_(layer.bias)
    return layer


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class Block(nn.Module):
    """flax ``Block``: pre-norm attention, then the pre-norm GELU MLP."""

    def __init__(self, embed_dim: int, num_heads: int, head_dim: int,
                 mlp_dim: int, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Callable = default_attention, causal: bool = True):
        super().__init__()
        self.dtype = dtype
        self.norm1 = RMSNorm(embed_dim, dtype)
        self.attn = Attention(embed_dim, num_heads, head_dim, dtype, attn_fn,
                              causal)
        self.norm2 = RMSNorm(embed_dim, dtype)
        self.fc1 = _dense(embed_dim, mlp_dim)
        self.fc2 = _dense(mlp_dim, embed_dim)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), positions)
        h = _linear(self.fc1, self.norm2(x), self.dtype)
        h = F.gelu(h, approximate="tanh")
        return x + _linear(self.fc2, h, self.dtype)


class Transformer(nn.Module):
    """flax ``Transformer``: the decoder-only LM. ``attn_fn`` swaps in
    ring or Ulysses attention for context parallelism, or the fused
    kernels. Weights are drawn from ``seed`` at flax's scales (different
    numbers)."""

    causal = True

    def __init__(self, vocab_size: int = 32000, num_layers: int = 4,
                 num_heads: int = 8, head_dim: int = 64,
                 embed_dim: int = 512, mlp_dim: int = 2048,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Callable = default_attention, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.embed = nn.Embedding(vocab_size, embed_dim)
            nn.init.normal_(self.embed.weight,
                            std=1.0 / math.sqrt(embed_dim))
            self.blocks = nn.ModuleList(
                Block(embed_dim, num_heads, head_dim, mlp_dim, dtype,
                      attn_fn, self.causal) for _ in range(num_layers))
            self.norm = RMSNorm(embed_dim, dtype)
            self.fc = _dense(embed_dim, vocab_size)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """fp32 logits ``[B, S, vocab]``; ``positions`` default to
        ``0 .. S-1``."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.embed.weight.to(self.dtype)[tokens]
        for block in self.blocks:
            x = block(x, positions)
        x = self.norm(x)
        return _linear(self.fc, x, self.dtype).to(torch.float32)
