#!/usr/bin/env python3
"""Phases (k) and (l) of ``chip_smoke.py`` alone, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card::

    python3 scripts/process_phases.py [--phases k,l] [--seed 0]
                                      [--parent DIR] [--rounds 2]

It builds the CUDA kernels and the native core from the checkout's
sources, then runs (k), the process-mode ranks started by the port's
static launcher, and (l), the elastic ResNet-50 job started by its
elastic launcher, exactly as ``chip_smoke.py`` runs them, with their
checks, and prints the card, each phase's seconds and (l)'s numbers as a
JSON line.

``--parent DIR``, a checkout of another commit (unpacked with ``git
archive``), then runs (k) in alternating rounds, parent first (parent,
this tree, this tree, parent, ... ``--rounds`` pairs), each round in its
own tree with that tree's ``chip_smoke.py`` and package (built by that
tree's own build scripts), and prints rank 0's step ms of (k2) dense,
(k3) 4-bit, (k6) ZeRO-1 and (k4) the int4 wire for each round.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("from horovod_tpu_torch.utils import cuda_build, native_build; "
         "cuda_build.build(); native_build.build()")
ROUND = ("import json, chip_smoke as cs; r = cs.train_process({seed}, 2)[0]; "
         "print('ROUND ' + json.dumps({{k: r[k]['step_ms'] for k in "
         "('dense', 'maxmin', 'zero1', 'wire_int4')}}))")


def build(roots) -> None:
    """Each tree's kernels and core, built by its own scripts, at once."""
    with concurrent.futures.ThreadPoolExecutor(len(roots)) as pool:
        for f in [pool.submit(subprocess.run, [sys.executable, "-c", BUILD],
                              cwd=root, check=True) for root in roots]:
            f.result()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="k,l",
                        help="comma-separated: k, l")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", default=None, metavar="DIR",
                        help="a checkout to run (k) against, in rounds")
    parser.add_argument("--rounds", type=int, default=2,
                        help="pairs of rounds with --parent")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("process_phases: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    parent = os.path.abspath(args.parent) if args.parent else None
    t0 = time.perf_counter()
    build([ROOT] + ([parent] if parent else []))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    ranks = cs.process_ranks()
    phases = args.phases.split(",")
    if "k" in phases:
        t0 = time.perf_counter()
        cs.train_process(args.seed, ranks)
        print(f"(k) passed in {time.perf_counter() - t0:.1f} s", flush=True)
    if "l" in phases:
        t0 = time.perf_counter()
        res = cs.train_elastic(args.seed, ranks)
        print(f"(l) passed in {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps(res), flush=True)
    if parent:
        order = ["parent", "tree", "tree", "parent"] * args.rounds
        for name in order[:2 * args.rounds]:
            out = subprocess.run(
                [sys.executable, "-c", ROUND.format(seed=args.seed)],
                cwd=parent if name == "parent" else ROOT,
                capture_output=True, text=True)
            rounds = [line for line in out.stdout.splitlines()
                      if line.startswith("ROUND ")]
            if out.returncode != 0 or not rounds:
                print(out.stdout[-4000:], out.stderr[-4000:], flush=True)
                raise SystemExit(f"(k) round of {name} failed")
            print(f"(k) {name} {rounds[-1][len('ROUND '):]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
