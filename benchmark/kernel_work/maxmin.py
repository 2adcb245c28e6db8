"""The max-min kernels B1, B3 and B4 of one ``scatter_allgather`` step:
their names in a trace's device events and the bytes and operations each
launch needs.

Frozen from ``chip_smoke.py`` (``TRACE_KERNELS``; ``kernel_work``'s
formulas, ``PATH_LAUNCHES``): every input byte is read once and every
output byte written once, whatever a kernel reads again; operations are
fp32 operations outside the tensor cores.

* B1 ``maxmin_quantize`` reads ``values`` fp32 values and writes one code
  byte a value of the padded buckets and each bucket's min and unit
  (8 bytes); 7 operations a padded value (min, max, subtract, divide,
  round, clamp, convert).
* B4 ``maxmin_dequantize`` reads ``rows`` rows of packed codes
  (``bits`` a value) and every bucket's min and unit, and writes the fp32
  values; 2 operations a value (``min + q * unit``).
* B3 ``maxmin_dequantize_sum`` reads ``ranks`` rows of packed codes and
  their mins and units and writes one rank's fp32 values: their sum; 3
  operations a value a rank.

A step at a world of n, on a fused gradient of ``count`` values cut into n
chunks of ``chunk`` values (``padded`` to whole buckets): B1 on the n
padded rows, B4 on them (the residual), B3 on the n ranks' rows of this
rank's chunk, B1 on the reduced chunk, B4 on the n gathered chunks.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# A wrapper's kernels, as a trace's device events name them: B3 and B4
# are one template, summing or not.
TRACE_KERNELS: Dict[str, Tuple[str, ...]] = {
    "maxmin_quantize": ("maxmin_quantize_kernel",),
    "maxmin_dequantize_sum": ("maxmin_decode_packed_kernel<true",
                              "maxmin_decode_generic_kernel<true"),
    "maxmin_dequantize": ("maxmin_decode_packed_kernel<false",
                          "maxmin_decode_generic_kernel<false"),
}


def kernel_of(name: str):
    """The wrapper whose kernel a device event's ``name`` is, or None."""
    for wrapper, prefixes in TRACE_KERNELS.items():
        if any(p in name for p in prefixes):
            return wrapper
    return None


def _buckets(values: int, bucket: int) -> int:
    return -(-values // bucket)


def quantize(values: int, bucket: int) -> Tuple[int, int]:
    """(bytes, operations) of B1 on ``values`` fp32 values."""
    buckets = _buckets(values, bucket)
    padded = buckets * bucket
    return 4 * values + padded + 8 * buckets, 7 * padded


def dequantize(rows: int, buckets_per_row: int, bucket: int,
               bits: int) -> Tuple[int, int]:
    """(bytes, operations) of B4 on ``rows`` packed rows."""
    values = rows * buckets_per_row * bucket
    return (values * bits // 8 + 8 * rows * buckets_per_row + 4 * values,
            2 * values)


def dequantize_sum(ranks: int, buckets: int, bucket: int,
                   bits: int) -> Tuple[int, int]:
    """(bytes, operations) of B3 on ``ranks`` rows of ``buckets``."""
    values = buckets * bucket
    return (ranks * values * bits // 8 + 8 * ranks * buckets + 4 * values,
            3 * ranks * values)


def step_launches(count: int, world: int, bits: int, bucket: int
                  ) -> List[Tuple[str, int, int]]:
    """(wrapper, bytes, operations) of every launch of one step."""
    chunk = -(-count // world)
    buckets = _buckets(chunk, bucket)
    padded = buckets * bucket
    return [
        ("maxmin_quantize", *quantize(world * padded, bucket)),
        ("maxmin_dequantize", *dequantize(world, buckets, bucket, bits)),
        ("maxmin_dequantize_sum", *dequantize_sum(world, buckets, bucket,
                                                  bits)),
        ("maxmin_quantize", *quantize(chunk, bucket)),
        ("maxmin_dequantize", *dequantize(world, buckets, bucket, bits)),
    ]


def least_seconds(nbytes: int, ops: int, peaks: dict) -> float:
    """A launch's least time: its bytes at the memory rate or its
    operations at the fp32 rate, whichever is longer."""
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["fp32_flops"])
