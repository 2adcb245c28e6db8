"""Adasum adaptive summation over the ranks of a process group.

Counterpart of ``horovod_tpu/parallel/adasum.py`` (``adasum_p`` :37-153,
``adasum_reference`` :156-182); reference ``horovod/common/ops/adasum/
adasum.h:38``. A pair of gradients ``a``, ``b`` combines as::

    a_coeff = 1 - dot(a, b) / (2 |a|^2)      (1 if |a|^2 == 0)
    b_coeff = 1 - dot(a, b) / (2 |b|^2)      (1 if |b|^2 == 0)
    result  = a_coeff a + b_coeff b

so orthogonal gradients add and parallel ones average.

:func:`adasum` is the JAX package's vector-halving distance-doubling: ranks
past the largest power of two ``p`` first add their vector into rank
``r - p``; at level ``L`` each rank sends the half its partner ``r ^ L``
keeps and combines the half it keeps; the halves are pieces of the two
logical vectors, so the coefficients need the dot products and norms of
the whole vectors, which are the sums of every piece's partials over the
``2L`` ranks that hold them (one small allgather a level, as the JAX
package does); at the end rank ``j`` holds the segment at ``bitrev(j)``,
and one allgather reassembles the vector.

It runs on a fused buffer of several tensors (``sizes``), each with its own
coefficients, as the JAX package's one ``adasum_p`` a tensor computes them
(and the reference's ``FusedPairwiseReduceWithComm``): the tensors' pieces
are contiguous, so float64 prefix sums of the ``(a·b, a·a, b·b)``
products, read at the pieces' boundaries, give every tensor's partials at
once (exact to far below fp32, and the same on every run, where an
``index_add_`` of fp32 products into 161 slots serializes on its atomics
and rounds each addition into a large sum); a segment-id vector gives
every element its tensor's coefficients; and one exchange a level carries
every tensor's partials. Everything stays on the device: no partial or
coefficient comes back to the host.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..ops import collectives as C

_SEGMENTS: Dict[tuple, Tuple[torch.Tensor, Tuple[int, ...]]] = {}
_BOUNDS: Dict[tuple, torch.Tensor] = {}


def segments(sizes: Sequence[int], length: int, device
             ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``ids``, ``[length]`` int64: each element's tensor, in order, the
    elements past ``sum(sizes)`` (the padding) the extra id
    ``len(sizes)``; and ``ends``, the offset where each id's elements end.
    Cached by layout."""
    key = (tuple(sizes), length, str(device))
    if key not in _SEGMENTS:
        counts = list(sizes) + [length - sum(sizes)]
        ids = torch.repeat_interleave(torch.arange(len(counts)),
                                      torch.tensor(counts))
        ends = tuple(itertools.accumulate(counts))
        _SEGMENTS[key] = (ids.to(device), ends)
    return _SEGMENTS[key]


def bounds(ends: Tuple[int, ...], start: int, stop: int, device
           ) -> torch.Tensor:
    """Where each segment's elements begin and end in the piece
    ``[start, stop)`` of the layout: ``[len(ends) + 1]`` int64 offsets into
    the piece (a segment absent from it begins where it ends). Cached."""
    key = (ends, start, stop, str(device))
    if key not in _BOUNDS:
        cuts = [0] + [min(max(e, start), stop) - start for e in ends]
        _BOUNDS[key] = torch.tensor(cuts, device=device)
    return _BOUNDS[key]


def partials(a: torch.Tensor, b: torch.Tensor, cuts: torch.Tensor
             ) -> torch.Tensor:
    """``[k, 3]`` fp32: each segment's ``(a·b, a·a, b·b)`` over the piece
    whose segment offsets are ``cuts``, from float64 prefix sums (each a
    1-D ``cumsum``, which the card scans in one pass; a scan down dim 0 of
    a ``[n, 3]`` tensor runs a thread a column)."""
    sums = []
    for prod in (a * b, a * a, b * b):
        prefix = torch.cumsum(prod.to(torch.float64), 0)
        # The prefix sum before offset c: 0 at c = 0.
        at = torch.where(cuts > 0, prefix[(cuts - 1).clamp(min=0)], 0.0)
        sums.append(at[1:] - at[:-1])
    return torch.stack(sums, dim=1).to(torch.float32)


def combine(a: torch.Tensor, b: torch.Tensor, sums: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    """``a_coeff a + b_coeff b`` with each segment's coefficients from its
    summed ``(a·b, a·a, b·b)`` (JAX ``_combine``, ``adasum.py:30-34``)."""
    dot, na2, nb2 = sums.unbind(1)
    one = torch.ones_like(dot)
    a_coeff = torch.where(na2 == 0, one,
                          1.0 - dot / (2.0 * torch.where(na2 == 0, one, na2)))
    b_coeff = torch.where(nb2 == 0, one,
                          1.0 - dot / (2.0 * torch.where(nb2 == 0, one, nb2)))
    return a_coeff[ids] * a + b_coeff[ids] * b


def _bitrev(m: int, bits: int) -> int:
    out = 0
    for k in range(bits):
        if m & (1 << k):
            out |= 1 << (bits - 1 - k)
    return out


def adasum(x: torch.Tensor, axis=None, group=None,
           sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Adasum of ``x`` over the ranks of mesh axis ``axis`` (or ``group``;
    the data-parallel axis by default), computed in fp32 and returned in ``x``'s dtype
    and shape. ``sizes``: the lengths of the tensors fused in ``x``, each
    combined with its own coefficients (default: ``x`` is one tensor). At
    one rank ``x`` is returned as it is (JAX ``adasum.py:61-62``)."""
    runtime.require_spmd("adasum (the VHDD exchange)")
    if group is None:
        group = runtime.group(axis)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x
    v = x.reshape(-1).to(torch.float32)
    count = v.numel()
    sizes = [count] if sizes is None else list(sizes)
    if sum(sizes) != count:
        raise ValueError(f"sizes {sizes} do not add up to {count}")

    # Ranks past the largest power of two fold into their partner by plain
    # addition (JAX adasum.py:71-78).
    p = 1 << (n.bit_length() - 1)
    if idx >= p:
        C.send_recv({"v": v}, idx - p, group=group)
    elif idx < n - p:
        v = v + C.send_recv(recv_like={"v": v}, src=idx + p,
                            group=group)["v"]

    # Pad so the segment halves evenly at every level.
    length = -(-count // p) * p
    if length > count:
        v = torch.cat([v, v.new_zeros(length - count)])
    ids, ends = segments(sizes, length, v.device)
    seg, offset = v, 0  # this rank's piece and where it starts
    level = 1
    while level < p:
        half = seg.numel() // 2
        if idx < p:
            upper = bool(idx & level)
            keep, send = (seg[half:], seg[:half]) if upper else \
                (seg[:half], seg[half:])
            offset += half if upper else 0
            other = C.send_recv({"v": send}, idx ^ level, {"v": keep},
                                idx ^ level, group=group)["v"]
            a, b = (other, keep) if upper else (keep, other)
            mine = partials(a, b, bounds(ends, offset, offset + half,
                                         v.device))
        else:
            mine = torch.zeros(len(ends), 3, dtype=torch.float32,
                               device=v.device)
        gathered = C._allgather_even(mine.unsqueeze(0), group)
        if idx < p:
            lo = idx // (2 * level) * (2 * level)
            seg = combine(a, b, gathered[lo:lo + 2 * level].sum(0),
                          ids[offset:offset + half])
        else:
            seg = seg[:half]
        level *= 2

    # Member j's segment sits at offset length * bitrev(j) / p.
    rows = C._allgather_even(seg.unsqueeze(0), group)
    bits = p.bit_length() - 1
    out = torch.cat([rows[_bitrev(m, bits)] for m in range(p)])[:count]
    return out.view(x.shape).to(x.dtype)


def adasum_reference(tensors: Sequence[np.ndarray]) -> np.ndarray:
    """NumPy model of the Adasum reduction of one tensor over the ranks
    whose copies ``tensors`` holds, in float64 (the test oracle; a copy of
    JAX ``adasum_reference``, ``adasum.py:156-182``)."""
    vecs = [np.asarray(t, dtype=np.float64).reshape(-1) for t in tensors]
    n = len(vecs)
    p = 1
    while p * 2 <= n:
        p *= 2
    for i in range(n - p):
        vecs[i] = vecs[i] + vecs[p + i]

    def rec(lo: int, count: int) -> np.ndarray:
        if count == 1:
            return vecs[lo]
        half = count // 2
        a = rec(lo, half)
        b = rec(lo + half, half)
        dot = float(np.dot(a, b))
        na2 = float(np.dot(a, a))
        nb2 = float(np.dot(b, b))
        a_coeff = 1.0 if na2 == 0 else 1.0 - dot / (2.0 * na2)
        b_coeff = 1.0 if nb2 == 0 else 1.0 - dot / (2.0 * nb2)
        return a_coeff * a + b_coeff * b

    out = rec(0, p)
    return out.reshape(np.asarray(tensors[0]).shape)
