"""A run with the timed path broken underneath comes out not correct;
the same run left whole comes out correct. Each drives ``run.py`` on the
CPU (its look for a card skipped by ``--device cpu``) over the tiny cells,
once for each fault a training cell can have: a step that returns its
state unchanged, half of the batch left out, at a world of one a residual
that error feedback never writes again, and, at a world of 4, the
exchange between ranks left out. A run in which a rank other than 0 loads
JAX prints no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH

RUNNER = BENCH / "tests" / "fault_runner.py"
CASES = [
    ("tiny_resnet.maxmin4.graph", None),
    ("tiny_resnet.maxmin4.graph", "unchanged"),
    ("tiny_resnet.maxmin4.graph", "half_batch"),
    ("tiny_resnet.maxmin4.graph", "frozen_residual"),
    ("tiny_vgg.maxmin4.eager", None),
    ("tiny_vgg.maxmin4.eager", "unchanged"),
    ("tiny_vgg.maxmin4.eager", "half_batch"),
    ("tiny_vgg.maxmin4.eager", "frozen_residual"),
    ("tiny_vgg.maxmin4.eager.w4", None),
    ("tiny_vgg.maxmin4.eager.w4", "no_exchange"),
]


def _launch(checkout, cell: str, fault) -> subprocess.CompletedProcess:
    args = ["--workload", cell, "--seed", "3000000019", "--seconds", "0.01",
            "--trace", "0", "--device", "cpu", "--checkout", str(checkout)]
    cmd = [sys.executable, str(RUNNER), fault, *args] if fault else \
        [sys.executable, str(BENCH / "run.py"), *args]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=str(checkout), env=env)


def _run(checkout, cell: str, fault) -> dict:
    out = _launch(checkout, cell, fault)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'whole'}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(tiny_checkout, cell, fault):
    result = _run(tiny_checkout, cell, fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert result["metrics"]["setup_s"]["value"] > 0


def test_jax_in_another_rank_leaves_no_result(tiny_checkout):
    out = _launch(tiny_checkout, "tiny_vgg.maxmin4.eager.w4", "jax_in_rank")
    assert out.returncode != 0
    assert '"correct"' not in out.stdout, out.stdout[-2000:]
    assert "'jax'" in out.stderr and "1: " in out.stderr, out.stderr[-2000:]
