"""Per-block recompute: ``remat="full"`` and ``remat="dots"``.

Counterpart of the JAX GPT's ``_block_fn`` (``horovod_tpu/models/gpt.py:
232-244``): ``jax.checkpoint`` of the block, and for ``"dots"`` the policy
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, which keeps
the output of every ``dot_general`` without batch dimensions (the q, k, v,
o, up and down projections; in a switch block the router, the dispatch of
tokens to slots and the combine) and recomputes the rest in backward: the
elementwise work, the batched products (attention's ``q kᵀ`` and ``p v``,
the experts' products) and the flash kernel, which JAX sees as a custom
call, not a dot.

The port runs ``torch.utils.checkpoint`` with a selective-checkpoint
policy. ``torch.einsum`` may lower a product without batch dimensions to
``aten.bmm``, and a batched one to ``aten.mm``, so the policy cannot tell
them apart by the ATen op. It goes by role: the model computes the products
JAX saves through :func:`saved_einsum`, and the policy saves the output of
every matrix product that runs inside it and of nothing else.
"""

from __future__ import annotations

import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

MODES = ("none", "full", "dots")
_aten = torch.ops.aten
# The ATen products an einsum or a matmul dispatches to.
PRODUCTS = frozenset({_aten.mm.default, _aten.bmm.default,
                      _aten.addmm.default, _aten.baddbmm.default,
                      _aten.mv.default, _aten.dot.default})
_role = threading.local()


def saved_einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of a product without batch dimensions: the one
    ``remat="dots"`` keeps."""
    _role.saved = True
    try:
        return torch.einsum(equation, *operands)
    finally:
        _role.saved = False


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in PRODUCTS and getattr(_role, "saved", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown remat mode {mode!r} "
                         "(expected 'none', 'full' or 'dots')")


def apply(mode: str, fn, *args):
    """``fn(*args)``, kept whole (``"none"``), recomputed in backward from
    its inputs (``"full"``) or with its saveable products kept
    (``"dots"``)."""
    if mode == "none":
        return fn(*args)
    if mode == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    check_mode(mode)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _dots_policy))
