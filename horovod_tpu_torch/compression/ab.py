"""Compressed against dense allreduce: the wire model and a live A/B.

Counterpart of ``horovod_tpu/compression/ab.py``; reference: the fork's
``HOROVOD_NCCL_FAKE_COMPRESSION`` knob, which measures what compression
does to the time of a step apart from what it does to the numbers. It
answers "would the compressed slow hop beat the dense one on this link?"
without changing what training computes:

* a closed-form ring-allreduce wire model (:func:`projected_step_seconds`,
  :func:`crossover_gbps`): dense moves ``2 · nbytes`` a link direction,
  compressed ``2 · comp_bytes`` plus its quantize and dequantize time, so
  compression wins below the crossover link speed;
* a live calibration (:func:`autotune_compressed`) that times the dense
  hierarchical allreduce against ``hierarchical_compressed_allreduce`` on
  the live mesh (an injectable ``measure`` for bandwidth-model tests; rank
  0's table broadcast to every rank). It is advisory: compression changes
  the numbers a step gives, so nothing switches it on by itself.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import runtime
from ..ops import collectives as C
from ..utils import logging as log
from .quantize import MaxMinQuantizer, NormalizedQuantizer, TopKCompressor


def payload_nbytes(compressor, nelem: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """Wire bytes of ``compressor``'s payload for a buffer of ``nelem``
    values, per-bucket metadata included, without compressing anything
    (the JAX package reads it from ``jax.eval_shape``): the payload's
    formula for the quantizers and TopK, and a cast compressor's output on
    a ``meta`` tensor."""
    nelem = int(nelem)
    if isinstance(compressor, (MaxMinQuantizer, NormalizedQuantizer)):
        padded = compressor._padded(nelem)
        buckets = padded // compressor.bucket_size
        per_bucket = 8 if isinstance(compressor, MaxMinQuantizer) else 4
        return padded * compressor.bits // 8 + per_bucket * buckets
    if isinstance(compressor, TopKCompressor):
        return 8 * compressor._k(nelem)  # fp32 values, int32 indices
    wire, _ = compressor.compress(torch.empty(nelem, dtype=dtype,
                                              device="meta"))
    return wire.numel() * wire.element_size()


def projected_step_seconds(nbytes: int, comp_bytes: int, compute_s: float,
                           gbps: float) -> Tuple[float, float]:
    """``(dense_s, compressed_s)`` of one ring allreduce across a ``gbps``
    link: the wire takes ``2 · bytes / bandwidth`` (reduce and gather
    directions); the compressed form adds its compression time."""
    bw = gbps * 1e9 / 8.0
    return 2.0 * nbytes / bw, 2.0 * comp_bytes / bw + compute_s


def crossover_gbps(nbytes: int, comp_bytes: int,
                   compute_s: float) -> Optional[float]:
    """The link speed below which compression wins: where the bytes it
    saves in both ring directions take as long as its compute. ``None``
    when it can never win (no bytes saved); ``inf`` when it always wins
    (bytes saved at no compute)."""
    saved_bytes = 2.0 * (nbytes - comp_bytes)
    if saved_bytes <= 0:
        return None
    if compute_s <= 0:
        return float("inf")
    return saved_bytes * 8.0 / compute_s / 1e9


def _variant_fn(kind: str, inner_axis: str, outer_axis: str,
                compressor) -> Callable:
    """The dense hierarchical Sum allreduce, or the compressed one (the
    slow hop quantized by ``compressor``, ``scatter_allgather``)."""
    from .reducers import hierarchical_compressed_allreduce
    if kind == "dense":
        return lambda x: C._launch_hierarchical(x, C.ReduceOp.SUM,
                                                inner_axis,
                                                outer_axis).wait()
    return lambda x: hierarchical_compressed_allreduce(
        x, compressor, inner_axis, outer_axis, op=C.ReduceOp.SUM)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _default_measure(kind: str, nbytes: int, inner_axis: str,
                     outer_axis: str, reps: int, compressor) -> float:
    """Median seconds of one call on ``nbytes`` of fp32 ones over the live
    mesh, the host clock read after ``torch.cuda.synchronize()`` on the
    card (the compressed form's host work counts)."""
    dev = runtime.device()
    x = torch.ones(max(nbytes // 4, 1), dtype=torch.float32, device=dev)
    fn = _variant_fn(kind, inner_axis, outer_axis, compressor)
    fn(x)  # warm: the communicators are created on first use
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn(x)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def autotune_compressed(inner_axis: str, outer_axis: str,
                        sizes: Tuple[int, ...] = (1 << 20, 16 << 20),
                        reps: int = 5, compressor=None,
                        measure: Optional[Callable] = None
                        ) -> Dict[int, Tuple[str, float, float]]:
    """Time the dense and the compressed hierarchical allreduce at each
    size on the live mesh; returns ``{nbytes: ("dense" | "compressed",
    dense_s, compressed_s)}`` (JAX ``autotune_compressed``, :121).

    ``measure(kind, nbytes, inner_axis, outer_axis, reps) -> seconds``,
    ``kind`` ``"dense"`` or ``"compressed"``, replaces the timing (the
    bandwidth-model tests' hook). Default ``compressor``: 4-bit
    :class:`MaxMinQuantizer`. Rank 0's timings are broadcast to every rank
    before the winners are chosen, so every rank holds the same table.
    Advisory: ``DistributedOptimizer`` never reads it."""
    if compressor is None:
        compressor = MaxMinQuantizer(bits=4)
    if measure is None:
        def measure(kind, nbytes, ia, oa, reps):
            return _default_measure(kind, nbytes, ia, oa, reps, compressor)
    sizes_sorted = sorted(sizes)
    times = torch.tensor(
        [[measure("dense", nb, inner_axis, outer_axis, reps),
          measure("compressed", nb, inner_axis, outer_axis, reps)]
         for nb in sizes_sorted], dtype=torch.float64,
        device=runtime.device())
    times = C._broadcast(times, root_rank=0,
                         group=runtime.world_group()).tolist()
    results: Dict[int, Tuple[str, float, float]] = {}
    for (dense_s, comp_s), nbytes in zip(times, sizes_sorted):
        winner = "compressed" if comp_s < dense_s else "dense"
        results[nbytes] = (winner, dense_s, comp_s)
        log.info(f"autotune_compressed[{inner_axis},{outer_axis}] "
                 f"{nbytes >> 20}MB: dense={dense_s * 1e3:.3f}ms "
                 f"compressed={comp_s * 1e3:.3f}ms -> {winner}")
    return results
