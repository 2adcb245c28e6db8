"""Find what a cell is made of, by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. Each lives in a file of
its own, found by name, so that a later cell, configuration or metric is
added by adding files:

* ``BENCHMARK.json`` (the checkout's root): the cells, the configurations'
  files and the metrics with their units;
* ``configs/<config>.json``: the model, its batch and its optimizer;
* ``workloads/<traffic>.json``: the step's entry, the world, the
  gradient reducer and how many steps the set-up checks and traces;
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``metrics/<metric>.py``: one reader a metric (``read(run)``);
* ``flops/<family>.py``, ``reference/<family>.py``: a model family's
  FLOP counter and its plain reference;
* ``kernel_work/<name>.py``: a reducer's kernels, their names in the trace
  and their bytes and operations.

The packages ``reference``, ``flops`` and ``kernel_work`` are imported
with this directory on ``sys.path`` (``run.py`` puts it there).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at ``path`` as a module of its own (named after its
    path, so two readers of the same base name never collide)."""
    path = Path(path).resolve()
    name = "hvdbench_" + hashlib.sha256(str(path).encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path

    def path(self, *parts: str) -> Path:
        return self.bench_dir.joinpath(*parts)

    def reference(self):
        """The plain reference of the configuration's model family."""
        return importlib.import_module(f"reference.{self.config['family']}")

    def flops(self):
        return importlib.import_module(f"flops.{self.config['family']}")

    def kernel_work(self):
        """The reducer's kernel table, or None for a reducer that runs no
        kernel of its own."""
        name = self.traffic["reducer"].get("kernel_work")
        return None if name is None else importlib.import_module(
            f"kernel_work.{name}")

    def reader(self, metric: str):
        return load_module(self.path("metrics", f"{metric}.py"))


def load_cell(name: str, checkout: Optional[Path] = None,
              bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<checkout>/BENCHMARK.json``; its data files
    under ``bench_dir`` (the checkout's benchmark directory by default)."""
    checkout = Path(checkout or CHECKOUT)
    spec = load_json(checkout / "BENCHMARK.json")
    bench_dir = Path(bench_dir or checkout / spec["paths"][0])
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {checkout / 'BENCHMARK.json'}; "
                       f"cells: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(checkout / configs[entry["config"]]["file"])
    traffic = load_json(bench_dir / "workloads" / f"{entry['traffic']}.json")
    limits_path = bench_dir / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}

    def in_cell(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    end_to_end = [m for m in spec["end_to_end"] if in_cell(m)]
    reported = {m["name"] for m in end_to_end}

    def layer_in_cell(metric: dict) -> bool:
        if "workloads" in metric:
            return name in metric["workloads"]
        return metric["moves"] in reported

    per_layer = [m for m in spec["per_layer"] if layer_in_cell(m)]
    if traffic["world"] != entry["chips"]:
        raise ValueError(f"{name}: traffic {entry['traffic']!r} runs a world "
                         f"of {traffic['world']}, the cell asks for "
                         f"{entry['chips']} chips")
    return Cell(name=name, chips=entry["chips"], config_name=entry["config"],
                traffic_name=entry["traffic"], config=config, traffic=traffic,
                limits=limits, end_to_end=end_to_end, per_layer=per_layer,
                bench_dir=bench_dir)


def peaks(device_name: str, table: Optional[Dict] = None) -> Dict[str, float]:
    """The data-sheet rates of the card named ``device_name``: the longest
    key of ``peaks.json`` whose words all appear in the name."""
    table = table or load_json(HERE / "peaks.json")["cards"]
    for key in sorted(table, key=len, reverse=True):
        if all(word in device_name for word in key.split()):
            return table[key]
    raise KeyError(f"no data-sheet rates for {device_name!r} in peaks.json")
