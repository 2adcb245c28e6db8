"""The comparison that decides ``correct``: what the program's checked
steps produced against the plain reference's, on the same weights and
batches.

The numbers, each a gap relative to the reference:

* ``loss``: the largest gap between a rank's loss at a step and the
  reference's, over every rank and checked step;
* ``grad_leaf``, ``change_leaf``: by the worst leaf, the gap between the
  program's norm of a leaf and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf. ``grad`` is the
  first averaged gradient as the optimizer got it (the program's: SGD's
  momentum buffer after one step), ``change`` each parameter's change
  over the checked steps;
* ``grad_median``, ``change_median``: the same gap of the median leaf;
* ``grad_norm``, ``change_norm``: the gap of the norm of every leaf
  together;
* ``grad_diff``, ``change_diff``, ``grad_diff.<leaf>``,
  ``change_diff.<leaf>``: the norm of the difference over the reference's
  norm, every leaf together or one. Under 4-bit quantization a
  small error before the quantizer moves few values by a whole level and a
  larger one more, so the difference grows with the error where a gap of
  norms mostly cancels;
* ``raw_diff``, ``raw_diff.<leaf>``: the same of the first averaged
  gradient before the quantizer, every leaf together or one. The
  program's is what SGD got plus what error feedback kept back (at a world
  of one the sum is the gradient the quantizer was given, whatever levels
  it chose); only where the program gives it;
* ``reduce_diff``: at the last checked step (a replay of the captured
  step in a graph cell), what the program's reducer gave SGD against the
  reference reducer's answer to the same input, the norm of the
  difference over the norm of the answer, every value together. The
  input is what the program's reducer gave plus the residual it kept, as
  error feedback defines it, so a residual left unwritten, or an answer
  wrong anywhere, reads far above rounding. Only where the program gives
  its state (a world of one, with error feedback); the reference runs
  from the program's own input here, as the check of one stage.

A change leaves out the leaves whose first reference gradient is under a
thousandth of the median leaf's: their change is round-off alone.

A cell compares the numbers its ``limits/<cell>.json`` names, each held
to its limit there; ``PERF.md`` gives the readings each limit was set
from, and why a cell compares what it does. A reading that is not finite
is infinite, and fails any limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List, Optional

import torch

QUIET = 1e-3  # a leaf whose gradient is under this share of the median's


def _norms(leaves: Dict[str, torch.Tensor], names: List[str]) -> List[float]:
    return [float(torch.linalg.vector_norm(leaves[n].double()))
            for n in names]


def _finite_max(gaps) -> float:
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _gap(got: float, want: float) -> float:
    if want > 0:
        return abs(got - want) / want
    return 0.0 if got == want else math.inf


def _diff(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
          names: List[str]) -> float:
    num = sum(float(torch.linalg.vector_norm((got[n].double() -
                                               want[n].double()))) ** 2
              for n in names)
    den = sum(float(torch.linalg.vector_norm(want[n].double())) ** 2
              for n in names)
    return math.sqrt(num / den) if den > 0 and math.isfinite(num) else \
        math.inf


def _leaf_numbers(got: List[float], want: List[float], prefix: str
                  ) -> Dict[str, float]:
    floor = statistics.median(want)
    worst = _finite_max(abs(g - w) / max(w, floor) if max(w, floor) > 0
                        else (0.0 if g == w else math.inf)
                        for g, w in zip(got, want))
    middle = statistics.median(abs(g - w) / max(w, floor)
                               if max(w, floor) > 0 else 0.0
                               for g, w in zip(got, want))
    whole = _gap(math.sqrt(sum(g * g for g in got)),
                 math.sqrt(sum(w * w for w in want)))
    if not all(math.isfinite(g) for g in got):
        worst = middle = whole = math.inf
    return {f"{prefix}_leaf": worst, f"{prefix}_median": middle,
            f"{prefix}_norm": whole}


def _reduce_gap(late: Dict[str, torch.Tensor], reduce: Callable) -> float:
    want, _ = reduce([late["out"] + late["kept"]], None)
    num = float(torch.linalg.vector_norm((late["out"] - want).double()))
    den = float(torch.linalg.vector_norm(want.double()))
    return num / den if den > 0 and math.isfinite(num) else math.inf


def readings(program: dict, reference: dict,
             reduce: Optional[Callable] = None) -> Dict[str, float]:
    """Every number. ``program`` and ``reference``: ``losses`` (a list a
    rank, in ``ranks`` order; the ranks both hold are compared),
    ``first_grad`` and ``change`` (tensors by name); the program's
    ``late`` (``out`` and ``kept``, flat) with the reference reducer
    ``reduce`` gives ``reduce_diff``."""
    gaps = []
    for rank, want in zip(reference["ranks"], reference["losses"]):
        if rank not in program["ranks"]:
            continue
        got = program["losses"][program["ranks"].index(rank)]
        gaps += [abs(g - w) / abs(w) if math.isfinite(g) and w else
                 math.inf for g, w in zip(got, want)]
    out = {"loss": _finite_max(gaps)}
    names = sorted(reference["first_grad"])
    ref_grad = _norms(reference["first_grad"], names)
    out.update(_leaf_numbers(_norms(program["first_grad"], names), ref_grad,
                             "grad"))
    floor = QUIET * statistics.median(ref_grad)
    moved = [n for n, g in zip(names, ref_grad) if g >= floor]
    out.update(_leaf_numbers(_norms(program["change"], moved),
                             _norms(reference["change"], moved), "change"))
    kinds = [("grad", "first_grad", names), ("change", "change", moved)]
    if program.get("first_raw") is not None:
        kinds.append(("raw", "first_raw", names))
    for kind, key, leaves in kinds:
        out[f"{kind}_diff"] = _diff(program[key], reference[key], leaves)
        for n in leaves:
            out[f"{kind}_diff.{n}"] = _diff(program[key], reference[key], [n])
    if reduce is not None and program.get("late") is not None:
        out["reduce_diff"] = _reduce_gap(program["late"], reduce)
    return out


def judged(values: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """The numbers the cell's limits name, each beside its limit."""
    if not limits:
        raise ValueError("the cell has no limits: nothing decides correct")
    return {k: {"value": values[k], "limit": v["limit"]}
            for k, v in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
