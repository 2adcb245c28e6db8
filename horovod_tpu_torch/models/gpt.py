"""GPT: the decoder-only language model of the long-context path.

Counterpart of ``horovod_tpu/models/gpt.py`` (``GPTConfig`` :41,
``init_params`` :83, ``_block`` :206, ``forward`` :247, ``loss_fn`` :259).
The parameters carry the JAX package's names and layouts (``wq`` is
``[E, H, D]``, ``wo`` is ``[H, D, E]``, dense weights are ``[in, out]``),
so :func:`~horovod_tpu_torch.models.convert.gpt_params_to_torch` loads a
JAX parameter tree as it is, and the products are ``torch.einsum`` with the
JAX subscripts. Parameters are fp32; every weight is cast to ``cfg.dtype``
at its product and RMSNorm runs in fp32, at the same points as in JAX (no
autocast, which would round elsewhere).

No device mesh exists in the port yet, so ``GPTConfig`` leaves out the
JAX config's mesh axes (``tp_axis``, ``sp_axis``, ``ep_axis``) and expert
settings (``num_experts``, ``capacity_factor``) until the slices that bind
them, and attention dispatches as the JAX ``_attention`` does with unbound
axes: ``"flash"`` and ``"ulysses_flash"`` run the fused kernels
(:func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`),
``"dense"``, ``"ring"`` and ``"ulysses"`` run plain attention. Mixture of
experts and ``remat="dots"`` are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from .transformer import default_attention, rope

_FLASH = ("flash", "ulysses_flash")
_PLAIN = ("dense", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None      # GQA; default == num_heads
    head_dim: int = 64
    embed_dim: int = 512
    mlp_dim: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # "ring" | "ulysses" | "dense" | "flash" | "ulysses_flash"
    attention: str = "ring"
    moe_every: int = 0                       # > 0 is not ported yet
    # Per-block recompute: "none" keeps every activation; "full" keeps the
    # block inputs and recomputes the block in backward.
    remat: str = "none"                      # "none" | "full" | "dots"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * w).to(dtype)


def _dense(gen: torch.Generator, shape, fan_in: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=gen) /
                        math.sqrt(fan_in))


class Block(nn.Module):
    """One pre-norm block: attention, then the GELU MLP."""

    def __init__(self, cfg: GPTConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D, E, M = (cfg.num_heads, cfg.kv_heads, cfg.head_dim,
                           cfg.embed_dim, cfg.mlp_dim)
        self.attn_norm = nn.Parameter(torch.ones(E))
        self.wq = _dense(gen, (E, H, D), E)
        self.wk = _dense(gen, (E, Hkv, D), E)
        self.wv = _dense(gen, (E, Hkv, D), E)
        self.wo = _dense(gen, (H, D, E), H * D)
        self.mlp_norm = nn.Parameter(torch.ones(E))
        self.w_up = _dense(gen, (E, M), E)
        self.w_down = _dense(gen, (M, E), M)

    def _attention(self, q, k, v):
        if self.cfg.attention in _FLASH:
            return flash_attention(q, k, v, causal=True)
        return default_attention(q, k, v, causal=True)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        dt = self.cfg.dtype
        h = _rmsnorm(x, self.attn_norm, dt)
        q = torch.einsum("bse,ehd->bshd", h, self.wq.to(dt))
        k = torch.einsum("bse,ehd->bshd", h, self.wk.to(dt))
        v = torch.einsum("bse,ehd->bshd", h, self.wv.to(dt))
        attn = self._attention(rope(q, positions), rope(k, positions), v)
        x = x + torch.einsum("bshd,hde->bse", attn, self.wo.to(dt))
        h = _rmsnorm(x, self.mlp_norm, dt)
        up = torch.einsum("bse,em->bsm", h, self.w_up.to(dt))
        # jax.nn.gelu defaults to the tanh approximation.
        up = F.gelu(up, approximate="tanh")
        return x + torch.einsum("bsm,me->bse", up, self.w_down.to(dt))


class GPT(nn.Module):
    """Decoder-only LM. Parameters are drawn from ``seed`` in the order and
    scales of the JAX ``init_params`` (different numbers: torch's generator
    is not JAX's)."""

    def __init__(self, cfg: GPTConfig, seed: int = 0):
        super().__init__()
        if cfg.moe_every > 0:
            raise NotImplementedError("mixture-of-experts blocks are not "
                                      "ported yet (expert-parallel slice)")
        if cfg.attention not in _FLASH + _PLAIN:
            raise ValueError(f"unknown attention {cfg.attention!r}")
        if cfg.remat == "dots":
            raise NotImplementedError("remat='dots' is not ported yet")
        if cfg.remat not in ("none", "full"):
            raise ValueError(f"unknown remat mode {cfg.remat!r} "
                             "(expected 'none', 'full' or 'dots')")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        E, V = cfg.embed_dim, cfg.vocab_size
        self.embed = nn.Parameter(torch.randn((V, E), generator=gen) * 0.02)
        self.out_norm = nn.Parameter(torch.ones(E))
        self.lm_head = _dense(gen, (E, V), E)
        self.layers = nn.ModuleList(Block(cfg, gen)
                                    for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` in fp32 for int ``tokens [B, S]``;
        ``positions`` default to ``0 .. S-1``."""
        dt = self.cfg.dtype
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.embed.to(dt)[tokens]
        for block in self.layers:
            if self.cfg.remat == "full":
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = _rmsnorm(x, self.out_norm, dt)
        return torch.einsum("bse,ev->bsv", x,
                            self.lm_head.to(dt)).to(torch.float32)


def loss_fn(model: GPT, tokens: torch.Tensor, targets: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            ignore_index: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy over the targets that are not
    ``ignore_index`` (0 when there are none)."""
    logits = model(tokens, positions)
    mask = targets != ignore_index
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                            targets.reshape(-1), ignore_index=ignore_index,
                            reduction="sum")
    return total / mask.sum().to(torch.float32).clamp(min=1.0)
