"""Bidirectional (BERT-style) encoder with a masked-LM head.

Counterpart of ``horovod_tpu/models/encoder.py`` (``Encoder`` :26,
``masked_lm_loss`` :52): the decoder's ``Block`` with ``causal=False``, so
with ``attn_fn=flash_attention`` every token attends every token through
the non-causal kernels B7-B9.
"""

from __future__ import annotations

import torch

from .transformer import Transformer


class Encoder(Transformer):
    """Bidirectional encoder LM: token embedding, pre-norm blocks without
    a causal mask, the final RMSNorm and the vocabulary logits (the JAX
    ``Encoder``'s defaults: 4 layers, d512, 8 heads of 64, MLP 2048)."""

    causal = False


def masked_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy at the masked positions (``mask`` 1 where the
    input was masked) only. ``logits [B, S, V]``, ``targets [B, S]``."""
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, targets[..., None])[..., 0]
    mask = mask.to(logp.dtype)
    return -(logp * mask).sum() / torch.clamp(mask.sum(), min=1.0)
