"""The gradient exchange of the IST-DASLab fork's ``scatter_allgather``
reducer over bucketed max-min quantization with error feedback, for every
rank at once, in plain PyTorch (float32).

Max-min quantization of a vector, bucket by bucket (zero-padded to whole
buckets; the padding counts in the last bucket's min and max)::

    unit = (max - min) / (2**bits - 1)
    q    = round_half_even((x - min) / unit)      (unit 0: divide by 1)
    x'   = min + q * unit

``scatter_allgather`` at n ranks: each rank adds its residual to its
gradient, pads the sum to n equal chunks and quantizes each chunk on its
own (each padded to whole buckets); what that lost is the rank's new
residual. Rank j sums the decoded chunk j of every rank, quantizes the sum
again, and every rank gathers and decodes every rank's reduced chunk; the
result is divided by n (Average).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def roundtrip(x: torch.Tensor, bits: int, bucket: int) -> torch.Tensor:
    """``x`` (flat float32) quantized and decoded, its padding dropped."""
    count = x.numel()
    buckets = -(-count // bucket)
    rows = F.pad(x, (0, buckets * bucket - count)).view(buckets, bucket)
    lo = rows.amin(dim=1, keepdim=True)
    hi = rows.amax(dim=1, keepdim=True)
    unit = (hi - lo) / torch.full_like(hi, (1 << bits) - 1)
    safe = torch.where(unit == 0, torch.ones_like(unit), unit)
    q = torch.round((rows - lo) / safe).clamp(0, (1 << bits) - 1)
    return (lo + q * unit).view(-1)[:count]


def scatter_allgather(grads: Sequence[torch.Tensor],
                      residuals: Optional[List[torch.Tensor]], bits: int,
                      bucket: int) -> Tuple[torch.Tensor,
                                            Optional[List[torch.Tensor]]]:
    """The averaged gradient every rank gets, and each rank's new residual
    (None without error feedback). ``grads``: one flat float32 gradient a
    rank, in the order of the fused buffer."""
    n, count = len(grads), grads[0].numel()
    chunk = -(-count // n)
    decoded, new_residuals = [], []
    for r, grad in enumerate(grads):
        rows = torch.zeros(n * chunk, dtype=torch.float32,
                           device=grad.device)
        rows[:count] = grad if residuals is None else grad + residuals[r]
        rows = rows.view(n, chunk)
        dec = torch.stack([roundtrip(rows[j], bits, bucket)
                           for j in range(n)])
        new_residuals.append((rows - dec).reshape(-1)[:count].clone())
        decoded.append(dec)
    out = torch.empty(n * chunk, dtype=torch.float32, device=grads[0].device)
    for j in range(n):
        total = torch.zeros(chunk, dtype=torch.float32,
                            device=grads[0].device)
        for r in range(n):
            total = total + decoded[r][j]
        out[j * chunk:(j + 1) * chunk] = roundtrip(total, bits, bucket)
    return out[:count] / n, (None if residuals is None else new_residuals)


def make(reducer: dict):
    """The reducer a traffic file names: ``f(grads, residuals)``."""
    if reducer["reduction"] != "scatter_allgather":
        raise ValueError(f"no plain reference of the "
                         f"{reducer['reduction']!r} reduction")
    bits, bucket = reducer["bits"], reducer["bucket_size"]
    return lambda grads, residuals: scatter_allgather(grads, residuals,
                                                      bits, bucket)
