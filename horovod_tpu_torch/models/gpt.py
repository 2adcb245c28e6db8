"""GPT: the decoder-only language model, with tensor, sequence and expert
parallelism.

Counterpart of ``horovod_tpu/models/gpt.py`` (``GPTConfig`` :41,
``init_params`` :83, ``param_specs`` :129, ``_tp_psum`` :167,
``_attention`` :173, ``_block`` :206, ``_block_fn`` :232, ``forward``
:247, ``loss_fn`` :259, ``data_specs`` :287). The parameters carry the JAX
package's names and layouts (``wq`` is ``[E, H, D]``, ``wo`` is
``[H, D, E]``, dense weights are ``[in, out]``, a switch block's are under
``moe``), so :func:`~horovod_tpu_torch.models.convert.gpt_params_to_torch`
loads a JAX parameter tree as it is, and the products are ``torch.einsum``
with the JAX subscripts. Parameters are fp32; every weight is cast to
``cfg.dtype`` at its product and RMSNorm runs in fp32, at the same points
as in JAX (no autocast, which would round elsewhere).

Parallelism is the JAX model's, over the runtime's mesh (an axis of the
config that the mesh lacks is off):

* **tp** shards the heads and the MLP's hidden dim (``param_specs``);
  :func:`~horovod_tpu_torch.ops.spmd.pvary` enters each tensor-parallel
  region and :func:`~horovod_tpu_torch.ops.spmd.psum` leaves it (the o and
  down projections), Megatron's f and g.
* **sp** shards the sequence; attention is ring (``"ring"``), Ulysses
  (``"ulysses"``) or Ulysses around the fused kernels
  (``"ulysses_flash"``). ``"flash"`` is local attention and raises with a
  bound sp axis; ``"dense"``, and any attention without sp, is local.
* **ep** shards the experts of the switch blocks (every ``moe_every``-th),
  and the batch rides (dp, ep).

A model built on a rank holds that rank's shards: ``GPT(cfg, seed)`` draws
the global parameters and keeps its block of each, so every rank's shards
come from one model. One training step::

    loss = loss_fn(model, tokens, targets)   # this rank's shard of the batch
    loss.backward()
    opt.synchronize()                        # DistributedOptimizer(axis=dp)
    sum_replica_grads(model)                 # the sums over sp and ep
    with opt.skip_synchronize():
        opt.step()
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import runtime
from ..ops import remat, spmd
from ..ops.flash_attention import flash_attention
from ..ops.remat import saved_einsum
from ..parallel.axes import axis_bound, axis_index, local_shard
from .transformer import default_attention, rope

ATTENTION = ("ring", "ulysses", "dense", "flash", "ulysses_flash")


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
    # Mesh axis names; None (or an axis the mesh lacks) turns that
    # parallelism off.
    tp_axis: Optional[str] = "tp"
    sp_axis: Optional[str] = "sp"
    ep_axis: Optional[str] = None
    # "ring" | "ulysses" | "dense" | "flash" | "ulysses_flash"
    attention: str = "ring"
    # Every moe_every-th block (when > 0) is a switch layer of num_experts
    # experts.
    moe_every: int = 0
    num_experts: int = 8
    capacity_factor: float = 1.25
    # Per-block recompute: "none" keeps every activation; "full" keeps the
    # block inputs and recomputes the block in backward; "dots" also keeps
    # the products without batch dims (ops/remat.py).
    remat: str = "none"                      # "none" | "full" | "dots"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def _is_moe(cfg: GPTConfig, layer: int) -> bool:
    return cfg.moe_every > 0 and (layer + 1) % cfg.moe_every == 0


def param_specs(cfg: GPTConfig) -> Dict[str, Tuple]:
    """``state_dict`` name -> partition (an axis name, or None, for each
    dim): tp shards the heads and the MLP's hidden dim, ep the experts;
    everything else is replicated."""
    tp, ep = cfg.tp_axis, cfg.ep_axis
    specs: Dict[str, Tuple] = {"embed": (), "out_norm": (), "lm_head": ()}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        specs.update({p + "attn_norm": (), p + "wq": (None, tp, None),
                      p + "wk": (None, tp, None), p + "wv": (None, tp, None),
                      p + "wo": (tp, None, None), p + "mlp_norm": ()})
        if _is_moe(cfg, i):
            specs.update({p + "moe.gate": (), p + "moe.w_up": (ep, None, tp),
                          p + "moe.w_down": (ep, tp, None)})
        else:
            specs.update({p + "w_up": (None, tp), p + "w_down": (tp, None)})
    return specs


def data_specs(cfg: GPTConfig) -> Tuple:
    """Partition of ``tokens``/``targets``/``positions`` ``[B, S]``: the
    batch over dp, and over ep when experts are parallel; the sequence over
    sp. Slice a global batch with ``parallel.local_shard``."""
    dp = runtime.dp_axis() if runtime.is_initialized() else "dp"
    batch = (dp, cfg.ep_axis) if cfg.ep_axis else dp
    return (batch, cfg.sp_axis)


def _grad_sum_axes(cfg: GPTConfig) -> Tuple[str, ...]:
    """The data axes besides dp over which :func:`sum_replica_grads` sums:
    the sequence's, and the experts' (the batch rides them)."""
    return tuple(a for a in (cfg.sp_axis, cfg.ep_axis) if axis_bound(a))


def sum_replica_grads(model: "GPT") -> None:
    """The gradient sums over sp and ep that JAX's autodiff inserts, after
    ``opt.synchronize()`` (:func:`~horovod_tpu_torch.ops.spmd.
    sum_replica_grads`)."""
    spmd.sum_replica_grads(dict(model.named_parameters()),
                           param_specs(model.cfg), _grad_sum_axes(model.cfg))


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * w).to(dtype)


def _tp_psum(x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    return spmd.psum(x, cfg.tp_axis) if axis_bound(cfg.tp_axis) else x


def _tp_pvary(x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    return spmd.pvary(x, cfg.tp_axis) if axis_bound(cfg.tp_axis) else x


def _attention(cfg: GPTConfig, q, k, v):
    """The configured attention (JAX ``_attention``)."""
    sp = cfg.sp_axis
    if cfg.attention == "flash":
        if axis_bound(sp):
            raise ValueError(
                "attention='flash' is local attention; with a bound sp "
                "axis use 'ring', 'ulysses', or 'ulysses_flash' (the "
                "flash kernel as Ulysses' per-device attention)")
        return flash_attention(q, k, v, causal=True)
    if cfg.attention == "ulysses_flash":
        if not axis_bound(sp):
            return flash_attention(q, k, v, causal=True)
        from ..parallel.ulysses import ulysses_attention_p
        return ulysses_attention_p(q, k, v, causal=True, axis=sp,
                                   attn_fn=flash_attention)
    if not axis_bound(sp) or cfg.attention == "dense":
        return default_attention(q, k, v, causal=True)
    if cfg.attention == "ring":
        from ..parallel.ring_attention import ring_attention_p
        return ring_attention_p(q, k, v, causal=True, axis=sp)
    from ..parallel.ulysses import ulysses_attention_p
    return ulysses_attention_p(q, k, v, causal=True, axis=sp)


class _Params:
    """Draws global parameters in the order and at the scales of the JAX
    ``init_params`` (different numbers: torch's generator is not JAX's)
    and keeps this rank's block of each."""

    def __init__(self, seed: int, specs: Dict[str, Tuple]):
        self.gen = torch.Generator().manual_seed(seed)
        self.specs = specs

    def dense(self, name: str, shape, fan_in: int) -> nn.Parameter:
        return self.shard(name, torch.randn(shape, generator=self.gen) /
                          math.sqrt(fan_in))

    def shard(self, name: str, value: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(local_shard(value, self.specs[name]).clone(
            memory_format=torch.contiguous_format))


class SwitchMLP(nn.Module):
    """A switch block's router and this rank's experts."""

    def __init__(self, cfg: GPTConfig, init: _Params, prefix: str):
        super().__init__()
        E, M, n = cfg.embed_dim, cfg.mlp_dim, cfg.num_experts
        self.gate = init.dense(prefix + "gate", (E, n), E)
        self.w_up = init.dense(prefix + "w_up", (n, E, M), E)
        self.w_down = init.dense(prefix + "w_down", (n, M, E), M)


class Block(nn.Module):
    """One pre-norm block: attention, then the GELU MLP or a switch MLP."""

    def __init__(self, cfg: GPTConfig, init: _Params, layer: int):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D, E, M = (cfg.num_heads, cfg.kv_heads, cfg.head_dim,
                           cfg.embed_dim, cfg.mlp_dim)
        p = f"layers.{layer}."
        self.attn_norm = init.shard(p + "attn_norm", torch.ones(E))
        self.wq = init.dense(p + "wq", (E, H, D), E)
        self.wk = init.dense(p + "wk", (E, Hkv, D), E)
        self.wv = init.dense(p + "wv", (E, Hkv, D), E)
        self.wo = init.dense(p + "wo", (H, D, E), H * D)
        self.mlp_norm = init.shard(p + "mlp_norm", torch.ones(E))
        self.moe = None
        # The switch MLP's load-balance loss and dropped fraction of the
        # last forward; like the JAX block, the loss leaves them out.
        self.moe_aux: Optional[Dict[str, torch.Tensor]] = None
        if _is_moe(cfg, layer):
            self.moe = SwitchMLP(cfg, init, p + "moe.")
        else:
            self.w_up = init.dense(p + "w_up", (E, M), E)
            self.w_down = init.dense(p + "w_down", (M, E), M)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        h = _tp_pvary(_rmsnorm(x, self.attn_norm, dt), cfg)
        q = saved_einsum("bse,ehd->bshd", h, self.wq.to(dt))
        k = saved_einsum("bse,ehd->bshd", h, self.wk.to(dt))
        v = saved_einsum("bse,ehd->bshd", h, self.wv.to(dt))
        attn = _attention(cfg, rope(q, positions), rope(k, positions), v)
        o = saved_einsum("bshd,hde->bse", attn, self.wo.to(dt))
        x = x + _tp_psum(o, cfg)

        h = _rmsnorm(x, self.mlp_norm, dt)
        if self.moe is not None:
            from ..parallel.moe import switch_moe
            out, aux = switch_moe(
                h, self.moe.gate, self.moe.w_up, self.moe.w_down,
                axis=cfg.ep_axis, tp_axis=cfg.tp_axis,
                capacity_factor=cfg.capacity_factor, dtype=dt)
            self.moe_aux = {k: a.detach() for k, a in aux.items()}
            return x + out
        h = _tp_pvary(h, cfg)
        up = saved_einsum("bse,em->bsm", h, self.w_up.to(dt))
        # jax.nn.gelu defaults to the tanh approximation.
        up = F.gelu(up, approximate="tanh")
        down = saved_einsum("bsm,me->bse", up, self.w_down.to(dt))
        return x + _tp_psum(down, cfg)


class GPT(nn.Module):
    """Decoder-only LM; on a mesh, this rank's shards of it."""

    def __init__(self, cfg: GPTConfig, seed: int = 0):
        super().__init__()
        if cfg.attention not in ATTENTION:
            raise ValueError(f"unknown attention {cfg.attention!r}")
        remat.check_mode(cfg.remat)
        self.cfg = cfg
        init = _Params(seed, param_specs(cfg))
        E, V = cfg.embed_dim, cfg.vocab_size
        self.embed = init.shard(
            "embed", torch.randn((V, E), generator=init.gen) * 0.02)
        self.out_norm = init.shard("out_norm", torch.ones(E))
        self.lm_head = init.dense("lm_head", (E, V), E)
        self.layers = nn.ModuleList(Block(cfg, init, i)
                                    for i in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` in fp32 for int ``tokens [B, S]``, this
        rank's shard; ``positions`` (global) default to the contiguous
        layout of the sequence over sp."""
        dt = self.cfg.dtype
        if positions is None:
            S = tokens.shape[1]
            positions = (axis_index(self.cfg.sp_axis) * S + torch.arange(
                S, device=tokens.device)).expand(tokens.shape)
        x = self.embed.to(dt)[tokens]
        for block in self.layers:
            x = remat.apply(self.cfg.remat, block, x, positions)
        return self.head(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The out norm and the vocabulary projection: fp32 logits of the
        last block's output ``x [..., S, E]``."""
        x = _rmsnorm(x, self.out_norm, self.cfg.dtype)
        return torch.einsum("...se,ev->...sv", x, self.lm_head.to(
            self.cfg.dtype)).to(torch.float32)


def loss_fn(model: GPT, tokens: torch.Tensor, targets: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            ignore_index: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy over every global target that is not
    ``ignore_index`` (0 when there are none). The tokens are sharded over
    sp and, with experts, ep: the sums run over both, so every rank
    returns the same loss; the average over dp is the optimizer's."""
    logits = model(tokens, positions)
    mask = targets != ignore_index
    num = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), ignore_index=ignore_index,
                          reduction="sum")
    den = mask.sum().to(torch.float32)
    for ax in (model.cfg.sp_axis, model.cfg.ep_axis):
        if axis_bound(ax):
            num = spmd.psum(num, ax)
            den = spmd.psum(den, ax)
    return num / den.clamp(min=1.0)
