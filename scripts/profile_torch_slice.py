#!/usr/bin/env python3
"""Where the time of horovod_tpu_torch's main path goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card::

    python3 scripts/profile_torch_slice.py [--path PATH] [--steps 10]
                                           [--out DIR]

It builds one of the paths that ``chip_smoke.py`` drives, at a world of
one: ``resnet`` (ResNet-50, batch 64, 224x224, bf16 autocast,
``DistributedOptimizer`` with the 4-bit max-min ``scatter_allgather``
reducer and error feedback), the same with the normalized quantizer
(``resnet_uni``) or stochastic max-min rounding (``resnet_stochastic``),
``resnet_syncbn_adasum`` (the 53 batch norms as ``SyncBatchNorm``, the
dense gradients through ``DistributedOptimizer(op=Adasum,
hierarchical=("ici", "dcn"))`` on a ``{"dcn": 1, "ici": 1}`` mesh) beside
``resnet_dense`` (the same model with its batch norms and the dense
Average optimizer, on the same mesh), or ``gpt`` (the ``gpt_long_context_flash``
configuration with flash attention, 2 x 4096 tokens, remat ``full``, the
dense ``DistributedOptimizer`` and SGD), or one of its model-parallel
phases on a one-card mesh (``gpt_ulysses_flash``, ``gpt_ring``,
``gpt_moe``: ``chip_smoke.MP_PATHS``; the sums over sp and ep after the
wait), and, after warm-up:

1. times ``--steps`` steps after ``chip_smoke.py``'s warm-up on the host
   clock as ``chip_smoke.py`` does (and each on the device), then the
   phases of a step with CUDA events over as many steps, each
   followed by a synchronize: forward+backward (in which the gradient
   hooks launch the reductions; their count a step is printed), the wait
   for the reductions (``synchronize()``) and the inner SGD step;
2. traces 3 steps with ``torch.profiler``, prints the device time by
   kernel, the device operations a step (kernels, copies and fills) and
   the device's busy share of the traced window, and writes the Chrome
   trace under ``--out`` (``torch_{path}_trace.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=(*chip_smoke.PATH_LAUNCHES,
                                           "gpt", "resnet_dense",
                                           "resnet_syncbn_adasum",
                                           *chip_smoke.MP_PATHS),
                        default="resnet")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: CUDA is not available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = args.path in ("resnet_dense", "resnet_syncbn_adasum")
    mesh_shape, overrides = chip_smoke.MP_PATHS.get(args.path, (None, None))
    if mesh:
        mesh_shape = {"dcn": 1, "ici": 1}
    hvd.init(mesh_shape=mesh_shape)
    after_wait = None
    try:
        dev = hvd.device()
        if overrides is not None:
            from horovod_tpu_torch.models import gpt
            forward_backward = chip_smoke.gpt_forward_backward
            model, opt, inputs, targets = chip_smoke.make_mesh_gpt_slice(
                hvd, dev, **overrides)

            def after_wait():
                gpt.sum_replica_grads(model)
        elif args.path == "gpt":
            forward_backward = chip_smoke.gpt_forward_backward
            model, opt, inputs, targets = chip_smoke.make_gpt_slice(hvd, dev)
        elif mesh:
            forward_backward = chip_smoke.forward_backward
            model, opt, inputs, targets = chip_smoke.make_sync_adasum_slice(
                hvd, dev, sync=args.path == "resnet_syncbn_adasum")
        else:
            forward_backward = chip_smoke.forward_backward
            model, opt, inputs, targets = chip_smoke.make_slice(
                hvd, dev, chip_smoke.resnet_compressors()[args.path])
        inner_step = type(opt).__mro__[1].step
        launched = []

        def step(marks=None):
            if marks:
                marks[0].record()
            forward_backward(model, opt, inputs, targets)
            # None where the optimizer has no hooks (a tree before them).
            launched.append(getattr(opt, "hook_launches", None))
            if marks:
                marks[1].record()
            with torch.profiler.record_function("hvd.synchronize"):
                opt.synchronize()
                if after_wait is not None:
                    after_wait()
            if marks:
                marks[2].record()
            inner_step(opt)
            if marks:
                marks[3].record()

        for _ in range(chip_smoke.WARMUP):
            step()
        torch.cuda.synchronize()
        del launched[:]
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(args.steps + 1)]
        t0 = time.perf_counter()
        ends[0].record()
        for end in ends[1:]:
            step()
            end.record()
        torch.cuda.synchronize()
        free_running = (time.perf_counter() - t0) / args.steps * 1e3
        per_step = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]

        phases = {"forward_backward": 0.0, "reduce": 0.0, "sgd": 0.0}
        t0 = time.perf_counter()
        for _ in range(args.steps):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            step(marks)
            torch.cuda.synchronize()
            for (name, a, b) in zip(phases, marks, marks[1:]):
                phases[name] += a.elapsed_time(b) / args.steps
        wall = (time.perf_counter() - t0) / args.steps * 1e3
        print(json.dumps({"step_ms_free_running": free_running,
                          "free_running_device_ms_each_step": per_step,
                          "step_ms_synced_each_step": wall,
                          "phase_ms_device": phases,
                          "reductions_launched_in_backward": launched}),
              flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        # The "hvd.synchronize" range shows on the device timeline too; it
        # spans the device's work, it is none of it.
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and
                  e.key != "hvd.synchronize"]
        busy_us = sum(_self_device_us(e) for e in events)
        events.sort(key=_self_device_us, reverse=True)
        print(f"traced 3 steps: window {window_us / 1e3:.3f} ms, device busy "
              f"{busy_us / 1e3:.3f} ms ({100 * busy_us / window_us:.1f}%), "
              f"{sum(e.count for e in events) / 3:.1f} device operations a "
              f"step", flush=True)
        for e in events[:25]:
            print(f"  {_self_device_us(e) / 3e3:9.4f} ms/step  "
                  f"x{e.count // 3:<5d} {e.key[:90]}", flush=True)
        for e in prof.key_averages():
            if e.key == "hvd.synchronize" and \
                    e.device_type == torch.autograd.DeviceType.CPU:
                print(f"hvd.synchronize: host {e.cpu_time_total / 3e3:.3f} "
                      "ms/step", flush=True)
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, f"torch_{args.path}_trace.json"))
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
