"""The control and the planted faults come out not correct.

On the CPU, at a size a test run holds: the tiny VGG cell run as
configured (bf16 autocast) gives the program's readings, and the fp8
control and the faults (``control.py``) read above them, so that limits
set between hold the program and fail the rest. On the card
(``-m cuda``), each cell at its own size: the control fails one of the
cell's limits on three seeds, and so does each fault."""

from __future__ import annotations

import json
import math

import pytest
import torch

import control
import harness
import spec
from conftest import REPO

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


@pytest.fixture(scope="module")
def bf16_cell(tiny_checkout):
    cell = spec.load_cell("tiny_vgg.maxmin4.eager", tiny_checkout)
    cell.config = dict(cell.config, autocast="bfloat16")
    return cell


@pytest.mark.parametrize("seed", SEEDS)
def test_control_reads_above_the_program_at_a_tiny_size(bf16_cell, seed):
    cpu = torch.device("cpu")
    record = harness.run_rank(bf16_cell, seed, 0.01, False, "cpu")
    program = {k: c["value"] for k, c in
               harness.check(bf16_cell, seed, [record], cpu).items()}
    others = {line["variant"]: line["readings"]
              for line in control.readings(bf16_cell, seed, cpu)}
    assert set(others) == {"fp8", "half_batch", "frozen_residual",
                           "unchanged"}
    assert others["fp8"]["loss"] >= 3 * program["loss"], (program, others)
    for fault in ("half_batch", "frozen_residual", "unchanged"):
        assert any(others[fault][k] >= 10 * program[k] for k in program), \
            (fault, program, others[fault])


# The control runs the reference alone, every rank of a world on one card.
CARD_CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_control_and_faults_fail_the_cells_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")
    c = spec.load_cell(cell, REPO)
    for seed in SEEDS:
        for line in control.readings(c, seed, torch.device("cuda:0")):
            got = line["readings"]
            failed = [k for k, v in c.limits.items()
                      if not math.isfinite(got[k]) or got[k] > v["limit"]]
            assert failed, line
