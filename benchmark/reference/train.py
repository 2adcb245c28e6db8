"""The first steps of data-parallel training, in plain PyTorch: every
rank's forward and backward on its own batch (cross-entropy, the batch's
mean), the gradients fused in the given order and exchanged by the
reference reducer, then SGD with momentum (no dampening, no weight decay,
not Nesterov)::

    buf = g                  (first step)
    buf = momentum * buf + g (later steps)
    p   = p - lr * buf

The ranks share one copy of the weights, as data parallelism keeps them
equal. What the benchmark compares comes back: each rank's loss at each
step, the first averaged gradient (what SGD's momentum buffer holds after
one step), each parameter's change after the last step and, with one rank
and error feedback, what the reducer gave SGD at the last step and the
residual it kept then (``late``).

``fault`` plants one of the faults a benchmark must catch, in the
reference put in the program's place: ``"half_batch"`` (half of every
batch left out, the mean taken over the rest), ``"no_exchange"`` (no
exchange between ranks: rank 0 alone, stepping on its own gradient) or
``"unchanged"`` (a step that leaves the weights as they were) or
``"frozen_residual"`` (error feedback's residual written at the first step
and never again, as a captured step that reads a stale tensor would).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

FAULTS = (None, "half_batch", "no_exchange", "unchanged",
          "frozen_residual")


def train(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
          order: List[str], batch: Callable, world: int, steps: int,
          reduce: Callable, error_feedback: bool, lr: float,
          momentum: float, fault: Optional[str] = None) -> dict:
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    params = dict(model.named_parameters())
    if set(params) != set(order) or set(weights) != set(order):
        raise ValueError("the reference's parameters, the weights and the "
                         "fused order must name the same tensors")
    with torch.no_grad():
        for name in order:
            params[name].copy_(weights[name])
    ranks = [0] if fault == "no_exchange" else list(range(world))
    residuals = None
    if error_feedback:
        count = sum(params[n].numel() for n in order)
        residuals = [torch.zeros(count, dtype=torch.float32,
                                 device=params[order[0]].device)
                     for _ in ranks]
    losses: List[List[float]] = [[] for _ in ranks]
    bufs: Dict[str, torch.Tensor] = {}
    first = None
    for step in range(steps):
        grads = []
        for i, rank in enumerate(ranks):
            images, labels = batch(rank, step)
            if fault == "half_batch":
                half = images.shape[0] // 2
                images, labels = images[:half], labels[:half]
            model.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(images), labels)
            loss.backward()
            losses[i].append(float(loss.detach()))
            grads.append(torch.cat([params[n].grad.reshape(-1).float()
                                    for n in order]))
        if first is None:
            raw = torch.stack(grads).mean(dim=0) if len(grads) > 1 \
                else grads[0]
            first_raw = dict(zip(order, raw.split([params[n].numel()
                                                   for n in order])))
        out, fresh = reduce(grads, residuals)
        if fault != "frozen_residual" or step == 0:
            residuals = fresh
        del grads, fresh
        update = dict(zip(order, out.split([params[n].numel()
                                            for n in order])))
        if first is None:
            first = {n: update[n].view_as(params[n]).clone() for n in order}
            first_raw = {n: first_raw[n].view_as(params[n]).clone()
                         for n in order}
        if fault == "unchanged":
            continue
        with torch.no_grad():
            for n in order:
                g = update[n].view_as(params[n])
                if n in bufs:
                    bufs[n].mul_(momentum).add_(g)
                else:
                    bufs[n] = g.clone()
                params[n].add_(bufs[n], alpha=-lr)
    model.zero_grad(set_to_none=True)
    change = {n: (params[n].detach() - weights[n]) for n in order}
    late = {"out": out, "kept": residuals[0]} \
        if residuals is not None and len(ranks) == 1 else None
    return {"ranks": ranks, "losses": losses, "first_grad": first,
            "first_raw": first_raw, "change": change, "late": late}
