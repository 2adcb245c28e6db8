"""Neither the harness nor the reference loads JAX or the JAX package,
and the reference loads nothing of the measured program: each imported
in a fresh interpreter, the loaded modules' top-level names (the part
before the first dot) compared whole."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "horovod_tpu"}
PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {repo!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
HARNESS = """
import run, harness, spec, compare, inputs, trace_read
import horovod_tpu_torch
"""
REFERENCE = """
import reference.resnet, reference.vgg, reference.maxmin, reference.train
import flops.resnet, flops.vgg, kernel_work.maxmin
"""


def _top_level(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(BENCH), repo=str(REPO),
                                            imports=imports)],
        capture_output=True, text=True, timeout=300, cwd=str(BENCH),
        env={"PATH": "/usr/bin:/bin", "HOME": str(BENCH)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.mark.parametrize("imports", [HARNESS, REFERENCE],
                         ids=["harness", "reference"])
def test_no_jax(imports):
    assert not _top_level(imports) & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert "horovod_tpu_torch" not in loaded
    assert "torch" in loaded


def test_the_guard_names_what_it_finds(monkeypatch):
    import harness
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "horovod_tpu_torch_extra", object())
    assert "horovod_tpu" not in harness.forbidden_modules()
