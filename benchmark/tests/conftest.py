"""Fixtures of the benchmark's CPU tests: the benchmark's directory on
``sys.path`` and a checkout of tiny cells (ResNet and VGG of a few
channels on 64x64 and 32x32 images, 8 and 4 images a rank, in float32:
the CPU's bf16 differs from the card's) whose program is this repository's
``horovod_tpu_torch``.

Run from the root of the repository::

    python -m pytest benchmark/tests -q

Tests that need a card are marked ``cuda`` and skip elsewhere.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for path in (str(BENCH), str(REPO)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_CELLS = {
    "tiny_resnet.maxmin4.graph": ("tiny_resnet", "maxmin4.graph", 1),
    "tiny_vgg.maxmin4.eager": ("tiny_vgg", "maxmin4.eager", 1),
    "tiny_vgg.maxmin4.eager.w4": ("tiny_vgg", "maxmin4.eager.w4", 4),
}
# The tiny cells' limits: a sound run on the CPU reads under them. The
# reducer's own number exists at a world of one.
TINY_LIMITS = {"loss": {"limit": 0.02}, "grad_norm": {"limit": 0.1},
               "change_norm": {"limit": 0.15}}
TINY_REDUCE_LIMIT = {"reduce_diff": {"limit": 0.01}}


def tiny_configs() -> dict:
    resnet = json.loads((BENCH / "configs" / "resnet50.json").read_text())
    resnet.update(name="tiny_resnet", params=None, batch_per_chip=8,
                  autocast=None)
    resnet["arch"].update(stage_sizes=[1, 1, 1, 1], num_filters=8,
                          num_classes=10, image_size=64)
    resnet["port"]["kwargs"] = {"stage_sizes": [1, 1, 1, 1],
                                "num_filters": 8, "num_classes": 10}
    vgg = json.loads((BENCH / "configs" / "vgg16.json").read_text())
    vgg.update(name="tiny_vgg", params=None, batch_per_chip=4,
               autocast=None)
    vgg["arch"].update(cfg=[8, "M", 16, "M"], num_classes=10, image_size=32)
    vgg["port"]["kwargs"] = {"cfg": [8, "M", 16, "M"], "num_classes": 10,
                             "image_size": 32}
    return {"tiny_resnet": resnet, "tiny_vgg": vgg}


def make_checkout(root: Path) -> Path:
    """A checkout under ``root``: the benchmark's files, the tiny cells
    added by data files alone, and a link to this repository's program."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "horovod_tpu_torch").symlink_to(REPO / "horovod_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in tiny_configs().items():
        path = f"benchmark/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "tiny", "file": path,
                                "reduced": [], "why": "a CPU test"})
    for cell, (config, traffic, chips) in TINY_CELLS.items():
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": chips,
                                  "why": "a CPU test"})
        limits = TINY_LIMITS if chips > 1 else {**TINY_LIMITS,
                                                **TINY_REDUCE_LIMIT}
        (root / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))
