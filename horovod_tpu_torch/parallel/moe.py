"""Expert parallelism: top-1 (switch) mixture of experts over a mesh axis.

Counterpart of ``switch_moe`` (``horovod_tpu/parallel/moe.py:33-104``), in
the same static-shape form: a capacity-bounded one-hot dispatch, a tiled
all-to-all (:func:`~horovod_tpu_torch.ops.spmd.all_to_all`) that takes
each expert's slots to the rank that holds it, the local experts' GELU
MLP (its hidden dim optionally sharded over a tensor-parallel axis), the
reverse all-to-all and the gate-weighted combine.

The batch rides (dp, ep): each ep rank routes its own tokens, and holds
``num_experts / ep`` experts. The dispatch mask carries no gradient; the
router's flows through the combine weight (the switch estimator). Ties in
the router go to the first expert, as ``argmax`` does in both packages.
The router, the dispatch of tokens to slots and the combine are the
products ``remat="dots"`` keeps (:func:`~horovod_tpu_torch.ops.remat.
saved_einsum`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.remat import saved_einsum
from ..ops.spmd import all_to_all, psum, pvary
from .axes import axis_size


def switch_moe(x: torch.Tensor, gate_w: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, axis: Optional[str] = None,
               tp_axis: Optional[str] = None, capacity_factor: float = 1.25,
               dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-1 switch MoE layer.

    Args:
      x: ``[B, S, d]``, this rank's tokens.
      gate_w: ``[d, num_experts]`` router weights (replicated, fp32).
      w_up: ``[experts_local, d, m_local]``, this rank's experts (and its
        tensor-parallel part of m).
      w_down: ``[experts_local, m_local, d]``.
      axis: the expert-parallel mesh axis (None or absent: every expert is
        local).
      tp_axis: the axis that shards the experts' hidden dim, if any.
      capacity_factor: each expert takes ``ceil(T * cf / num_experts)``
        tokens of the T this rank routes; the rest are dropped.

    Returns ``(out [B, S, d], aux)``; ``aux`` holds the Switch
    Transformer's ``load_balance_loss`` and the ``dropped_fraction``.
    """
    B, S, d = x.shape
    n_ep = axis_size(axis)
    num_experts = w_up.shape[0] * n_ep
    split_tp = axis_size(tp_axis) > 1

    T = B * S
    xt = x.reshape(T, d)
    logits = saved_einsum("td,de->te", xt.to(torch.float32),
                          gate_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_prob, expert = probs.max(dim=-1)

    capacity = int(math.ceil(T * capacity_factor / num_experts))
    onehot = F.one_hot(expert, num_experts).to(torch.float32)
    # Each token's place in its expert's buffer, counted in fp32 as JAX
    # does (exact: every partial sum is an integer below 2^24); a place at
    # or past the capacity has no slot. The count runs along the inner dim
    # of the transpose: the card scans dim 0 of [T, E] one thread a column,
    # 1.26 ms at T = 8192.
    pos = torch.cumsum(onehot.t(), dim=1).t() - onehot
    keep = onehot * (pos < capacity)
    place = (pos * onehot).sum(dim=-1).to(torch.int64)
    slot = (place[:, None] == torch.arange(capacity, device=x.device)
            ).to(torch.float32)
    dispatch = torch.einsum("te,tc->tec", keep, slot)
    combine = dispatch * gate_prob[:, None, None]

    slots = saved_einsum("tec,td->ecd", dispatch.to(dtype), xt.to(dtype))
    if n_ep > 1:
        # [E, C, d] -> [E/n_ep, n_ep*C, d]: every peer's slots for the
        # experts held here.
        slots = all_to_all(slots, axis, split_axis=0, concat_axis=1)
    if split_tp:
        slots = pvary(slots, tp_axis)
    up = torch.einsum("ecd,edm->ecm", slots, w_up.to(dtype))
    up = F.gelu(up, approximate="tanh")
    out_slots = torch.einsum("ecm,emd->ecd", up, w_down.to(dtype))
    if split_tp:
        out_slots = psum(out_slots, tp_axis)
    if n_ep > 1:
        out_slots = all_to_all(out_slots, axis, split_axis=1, concat_axis=0)
    out = saved_einsum("tec,ecd->td", combine.to(dtype), out_slots)

    frac = onehot.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    lb_loss = num_experts * torch.sum(frac * mean_prob)
    dropped = 1.0 - keep.sum() / torch.clamp(onehot.sum(), min=1.0)
    return out.reshape(B, S, d), {"load_balance_loss": lb_loss,
                                  "dropped_fraction": dropped}
