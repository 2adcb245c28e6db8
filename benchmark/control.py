#!/usr/bin/env python3
"""Readings that bound a cell's limits: from above, the plain reference
put in the program's place, in the precision below the configuration's
(the control: fp8 for a bf16 configuration) and with each fault a training
cell can have planted (half of every batch left out; no exchange between
ranks, at a world above one; a step that leaves the weights unchanged;
at a world of one with error feedback, a residual never written after the
first step), each compared with the float32 reference as a run compares
the program. At the cell's own size, on one card (the reference runs
every rank of a world in one process)::

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

With ``--program``, from below: the program's own checked steps, as a
run drives them, a seed after another in one process (a world of one).

One JSON line a seed and variant: ``{"seed", "variant", "readings"}``, the
readings of the cell's compared numbers (``limits/<cell>.json``) and of
``SHOWN``. The benchmark's own runs do not run this; ``PERF.md`` gives
the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


# Besides the cell's compared numbers: each step's loss, the worst-leaf,
# median-leaf and whole-model norm gaps of the first gradient and of the
# change, their first-order differences, and the reducer's at the last
# step.
SHOWN = ("loss", "grad_leaf", "change_leaf", "grad_median", "change_median",
         "grad_norm", "change_norm", "grad_diff", "change_diff", "raw_diff",
         "reduce_diff")


def variants(traffic: dict):
    out = [("fp8", None), ("fp32", "half_batch")]
    if traffic["world"] > 1:
        out.append(("fp32", "no_exchange"))
    elif traffic["reducer"].get("error_feedback"):
        out.append(("fp32", "frozen_residual"))
    return out + [("fp32", "unchanged")]


def _shown(cell, values: dict) -> dict:
    return {k: values[k] for k in SHOWN + tuple(cell.limits) if k in values}


def readings(cell, seed: int, device) -> list:
    """Each variant's readings against the float32 reference, in the
    reference's order of the fused gradient."""
    import torch
    import compare
    import harness
    with torch.device("meta"):
        order = [n for n, _ in cell.reference().build(
            cell.config).named_parameters()]
    ref, _ = harness.reference_outputs(cell, seed, order, device)
    out = []
    for precision, fault in variants(cell.traffic):
        t0 = time.perf_counter()
        got, _ = harness.reference_outputs(cell, seed, order, device,
                                           precision, fault)
        values = compare.readings(got, ref, harness.reducer(cell))
        out.append({"seed": seed, "variant": fault or precision,
                    "readings": _shown(cell, values),
                    "seconds": time.perf_counter() - t0})
        del got
    return out


def program_readings(cell, seed: int, device) -> dict:
    """The program's readings at ``seed``: its checked steps as a run
    drives them (a window of a few steps after them), against the float32
    reference."""
    import harness
    if cell.traffic["world"] != 1:
        raise ValueError("the program's readings run a world of one here")
    t0 = time.perf_counter()
    record = harness.run_rank(cell, seed, 0.01, False, str(device))
    values = harness.readings(cell, seed, [record], device)
    return {"seed": seed, "variant": "program",
            "readings": _shown(cell, values),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--checkout", default=None)
    p.add_argument("--program", action="store_true",
                   help="the program's readings instead")
    args = p.parse_args(argv)
    checkout = os.path.abspath(args.checkout or os.path.dirname(HERE))
    sys.path[:0] = [HERE, checkout]
    import torch
    import spec
    cell = spec.load_cell(args.workload, checkout)
    device = torch.device(args.device)
    for seed in args.seeds:
        lines = [program_readings(cell, seed, device)] if args.program \
            else readings(cell, seed, device)
        for line in lines:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
