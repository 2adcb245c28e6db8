#!/usr/bin/env python3
"""The benchmark of ``horovod_tpu_torch`` on NVIDIA GPUs: one run of one
cell of ``BENCHMARK.json``, from the root of a checkout::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run builds the cell's model with weights drawn on the device from
``--seed``, drives it through the checked steps, measures ``--seconds`` of
steps (with ``--trace 1``, then traces some under ``torch.profiler``),
compares the checked steps with the plain reference under ``reference/``,
prints each compared number beside its limit as the last lines of standard
error, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks``. It exits non-zero without a result when
CUDA is absent, when the card has fewer devices than the cell's chips, when
the program is not the checkout's own, and when JAX or the JAX package
was loaded, in this process or in any other rank's. A cell on several chips runs one process a card, NCCL between
them; this process is rank 0 and starts the others.

The program's kernel build (``horovod_tpu_torch/_build``) and any other
cache of the run lie inside the checkout (``_bench_cache/``), at fixed
paths, so that only a checkout's first run builds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _environment(checkout: str) -> None:
    """Caches at fixed paths in the checkout; no JAX behind a library's
    back."""
    cache = os.path.join(checkout, "_bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="the length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by rank 0 for the other ranks of a world, and by the CPU tests.
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world-dir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--checkout", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    checkout = os.path.abspath(args.checkout or os.path.dirname(HERE))
    _environment(checkout)
    sys.path[:0] = [HERE, checkout]
    import torch
    import harness
    import spec

    cell = spec.load_cell(args.workload, checkout)
    if args.world_dir:
        record = harness.run_rank(cell, args.seed, args.seconds,
                                  bool(args.trace), args.device)
        record["forbidden"] = harness.forbidden_modules()
        harness.write_record(record, args.world_dir)
        return 0
    if args.device is None:
        if not torch.cuda.is_available():
            print("benchmark: CUDA is not available", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
                  f"devices, {torch.cuda.device_count()} present",
                  file=sys.stderr)
            return 2
    import horovod_tpu_torch
    here = os.path.abspath(horovod_tpu_torch.__file__)
    if not here.startswith(checkout + os.sep):
        print(f"benchmark: horovod_tpu_torch was loaded from {here}, not "
              f"from the checkout {checkout}", file=sys.stderr)
        return 2
    if args.device is None:
        from horovod_tpu_torch.utils import cuda_build
        cuda_build.build()  # before the other ranks start: one build
    world = harness.World(args, cell.chips) if cell.chips > 1 else None
    try:
        records = [harness.run_rank(cell, args.seed, args.seconds,
                                    bool(args.trace), args.device)]
        if world is not None:
            records += world.records()
    finally:
        if world is not None:
            world.stop()
    device = torch.device(args.device or "cuda:0")
    out = harness.result(cell, args.seed, records, bool(args.trace), device)
    records[0]["forbidden"] = harness.forbidden_modules()
    found = {r["rank"]: r["forbidden"] for r in records if r["forbidden"]}
    if found:
        print(f"benchmark: the run loaded {found} (by rank)", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
