#!/usr/bin/env python3
"""Smoke run of ``horovod_tpu_torch`` on one NVIDIA GPU (written for the
H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources, holds each kernel
against its plain PyTorch version on the card, then drives the port's main
path: ``hvd.init()`` (NCCL, a world of one), full-width ResNet-50 in bf16
autocast over ``channels_last``, and ``DistributedOptimizer`` sending the
gradients through the 4-bit max-min ``scatter_allgather`` reducer with error
feedback, for 2 warm-up and 10 timed steps. It checks that the loss is
finite and falls, that every step launched each kernel as often as the path
requires, and that the trained model agrees with a CPU copy of itself on a
small input. Then it times each kernel and its plain version at the shapes
of the path.

Output: the card's name and power limit as ``nvidia-smi`` reports them, a
``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
JSON lines; so does a machine without CUDA, or a directory without the
package.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BITS, BUCKET = 4, 512
RESNET50_PARAMS = 25_557_032  # the fused gradient buffer of the path
BATCH, IMAGE = 64, 224
WARMUP, STEPS = 2, 10
LR = 0.1 * BATCH / 256  # linear scaling: 10 steps without warm-up
REPLACES = {
    "maxmin_quantize":
        "horovod_tpu/compression/pallas_kernels.py:163",
    "maxmin_dequantize_sum":
        "horovod_tpu/compression/pallas_kernels.py:283",
    "maxmin_dequantize":
        "horovod_tpu/compression/pallas_kernels.py:317",
}
SOURCE = "horovod_tpu_torch/csrc/maxmin.cu"
# Data-sheet rates (dense, no sparsity): device-memory bytes/s and fp32
# operations/s outside the tensor cores.
RATES = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str):
    for key in sorted(RATES, key=len, reverse=True):
        if all(word in name for word in key.split()):
            return RATES[key]
    raise RuntimeError(f"no data-sheet rates for {name!r}")


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bitwise(got, want) -> bool:
    """Equal values, and NaN exactly where the other has NaN."""
    return got.shape == want.shape and bool(
        (torch.eq(got, want) | (torch.isnan(got) & torch.isnan(want))).all()
        if got.is_floating_point() else torch.equal(got, want))


def check_kernels(kernels, dev, n_values: int):
    """Every kernel against its plain version on the card; returns the
    largest error of each at the main path's shape. Besides the path's
    shape: ragged sizes with a constant first bucket and, where there is
    room, a bucket holding a NaN and one holding an inf."""
    gen = torch.Generator(device=dev).manual_seed(1)
    errors = {}
    cases = [(n_values, BITS, BUCKET, False)] + [
        (n, bits, bucket, True) for n in (1, 511, 513, 100_003)
        for bits in (1, 2, 4, 8) for bucket in (64, 512)]
    for n, bits, bucket, special in cases:
        x = torch.randn(n, generator=gen, device=dev) * 1e-2
        if special:
            x[:bucket] = 0.25
            x[bucket + 1:bucket + 2] = float("nan")
            x[2 * bucket + 3:2 * bucket + 4] = float("inf")
        got = kernels.maxmin_quantize(x, bits, bucket)
        want = kernels.maxmin_quantize_plain(x, bits, bucket)
        for g, w, what in zip(got, want, ("codes", "min", "unit")):
            if not bitwise(g, w):
                raise AssertionError(f"B1 {what} differ at n={n} bits={bits} "
                                     f"bucket={bucket}")
        back = kernels.maxmin_dequantize(*got)
        back_plain = kernels.maxmin_dequantize_plain(*got)
        if not bitwise(back, back_plain):
            raise AssertionError(f"B4 differs at n={n} bits={bits} "
                                 f"bucket={bucket}")
        if special and n > 2 * bucket and not (
                torch.isnan(back[1:3]).all() and torch.isfinite(back[0]).all()):
            raise AssertionError(f"a NaN or inf bucket decoded to a number "
                                 f"at n={n} bits={bits} bucket={bucket}")
        if n == n_values:
            errors["maxmin_quantize"] = max(
                float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want))
            errors["maxmin_dequantize"] = float(
                (back - back_plain).abs().max())
    n_buckets = -(-n_values // BUCKET)
    for n_ranks in (1, 2, 4):
        q = torch.randint(0, 1 << BITS, (n_ranks, n_buckets, BUCKET),
                          generator=gen, device=dev, dtype=torch.uint8)
        mn = torch.randn(n_ranks, n_buckets, generator=gen, device=dev)
        unit = torch.rand(n_ranks, n_buckets, generator=gen, device=dev) / 15
        got = kernels.maxmin_dequantize_sum(q, mn, unit)
        want = kernels.maxmin_dequantize_sum_plain(q, mn, unit)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        if n_ranks == 1:
            errors["maxmin_dequantize_sum"] = float((got - want).abs().max())
    torch.cuda.synchronize()
    return errors


def make_slice(hvd, dev):
    """The main path's model, optimizer and fixed synthetic batch."""
    from horovod_tpu_torch.compression import (CompressionConfig,
                                               MaxMinQuantizer)
    from horovod_tpu_torch.models import ResNet50

    torch.manual_seed(0)
    model = ResNet50(num_classes=1000).to(dev,
                                          memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=CompressionConfig(
            MaxMinQuantizer(bits=BITS, bucket_size=BUCKET),
            reduction="scatter_allgather", error_feedback=True))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    return model, opt, images, labels


def forward_backward(model, opt, images, labels):
    opt.zero_grad(set_to_none=True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    return loss.detach()


def train(hvd, dev):
    from horovod_tpu_torch.compression import kernels

    model, opt, images, labels = make_slice(hvd, dev)
    n_params = sum(p.numel() for p in model.parameters())

    def step():
        loss = forward_backward(model, opt, images, labels)
        opt.step()
        return loss

    losses = [step() for _ in range(WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [float(v) for v in losses]
    log(f"train: ResNet-50, {n_params} parameters, batch {BATCH}, "
        f"{IMAGE}x{IMAGE}, lr {LR}; losses {losses}")
    log(f"train: step {seconds / STEPS * 1e3:.3f} ms, "
        f"{BATCH * STEPS / seconds:.1f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches in "
        f"{STEPS} steps {launches}")
    if n_params != RESNET50_PARAMS:
        raise AssertionError(f"ResNet-50 has {n_params} parameters")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = {"maxmin_quantize": 2 * STEPS, "maxmin_dequantize_sum": STEPS,
            "maxmin_dequantize": 2 * STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    # The trained model against a CPU copy of itself, fp32, small input.
    model.eval()
    small = images[:2, :64, :64].contiguous()
    with torch.no_grad():
        got = model(small).cpu()
        ref = copy.deepcopy(model).cpu().float()(small.cpu())
    if got.shape != (2, 1000) or not torch.isfinite(got).all():
        raise AssertionError("bad logits")
    torch.testing.assert_close(got, ref, rtol=1e-3,
                               atol=1e-3 * float(ref.abs().max()))
    log("train: trained model agrees with its CPU copy (fp32, rtol 1e-3)")
    return launches


def measure(kernels, dev, n_values: int, launches, errors, rates):
    bandwidth, fp32 = rates
    n_buckets = -(-n_values // BUCKET)
    padded = n_buckets * BUCKET
    x = torch.randn(n_values, device=dev) * 1e-2
    q, mn, unit = kernels.maxmin_quantize(x, BITS, BUCKET)
    qs, mns, units = q[None], mn[None], unit[None]
    work = {
        # name: (kernel, plain, bytes moved, operations)
        "maxmin_quantize": (
            lambda: kernels.maxmin_quantize(x, BITS, BUCKET),
            lambda: kernels.maxmin_quantize_plain(x, BITS, BUCKET),
            4 * n_values + padded + 8 * n_buckets, 7 * padded),
        "maxmin_dequantize_sum": (
            lambda: kernels.maxmin_dequantize_sum(qs, mns, units),
            lambda: kernels.maxmin_dequantize_sum_plain(qs, mns, units),
            padded + 8 * n_buckets + 4 * padded, 3 * padded),
        "maxmin_dequantize": (
            lambda: kernels.maxmin_dequantize(q, mn, unit),
            lambda: kernels.maxmin_dequantize_plain(q, mn, unit),
            padded + 8 * n_buckets + 4 * padded, 2 * padded),
    }
    rows = []
    for name, (kernel, plain, nbytes, ops) in work.items():
        byte_ms, op_ms = nbytes / bandwidth * 1e3, ops / fp32 * 1e3
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None})
        log(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{max(byte_ms, op_ms):.4f} ms, {nbytes} bytes)")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compression import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)

    t0 = time.perf_counter()
    path = kernels.build()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")

    hvd.init()
    try:
        dev = hvd.device()
        errors = check_kernels(kernels, dev, RESNET50_PARAMS)
        log(f"kernels: B1 and B4 bitwise, B3 within rtol 1e-5; errors at "
            f"the path's shape {errors}")
        launches = train(hvd, dev)
        rows = measure(kernels, dev, RESNET50_PARAMS, launches, errors,
                       rates)
    finally:
        hvd.shutdown()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
