"""The benchmark's files are found by name, hold to BENCHMARK.json's shape,
and a new cell, configuration or metric is taken up by adding files."""

from __future__ import annotations

import json
import re

import pytest

import spec
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    names = [m["name"] for m in BENCHMARK["end_to_end"] +
             BENCHMARK["per_layer"]] + CELLS + \
        [c["name"] for c in BENCHMARK["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    metrics = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert "setup_s" in {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    four = sum(w["chips"] == 4 for w in BENCHMARK["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    pairs = {(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]}
    assert len(pairs) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    c = spec.load_cell(cell, REPO)
    assert c.chips == c.traffic["world"]
    assert c.limits, f"{cell} has no limits file"
    assert c.reference().build is not None
    assert c.flops().forward_macs(c.config) > 0
    assert c.kernel_work() is not None
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]).read), m["name"]
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer


@pytest.mark.parametrize("config", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_every_configuration_file_is_its_own(config):
    data = json.loads((REPO / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert config["file"].startswith("benchmark/")
    # Each departure from the source is a key of the file, and none is a
    # width.
    assert set(config["reduced"]) <= set(data)
    assert not [k for k in config["reduced"] if k.endswith(("_dim", "_rank"))
                or k in ("arch", "num_filters", "cfg", "params")]


def test_a_new_cell_and_metric_are_taken_up_from_files(tmp_path):
    """A configuration, a traffic mix, a limits file and a metric reader
    added as files, with BENCHMARK.json naming them: the harness finds
    each, unedited."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "vgg16.json").read_text())
    cfg.update(name="vgg11", params=132863336)
    cfg["arch"]["cfg"] = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M",
                          512, 512, "M"]
    (bench / "configs" / "vgg11.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "workloads" /
                          "maxmin4.eager.json").read_text())
    traffic["reducer"]["bits"] = 8
    (bench / "workloads" / "maxmin8.eager.json").write_text(
        json.dumps(traffic))
    (bench / "limits" / "vgg11.maxmin8.eager.json").write_text(
        json.dumps({"loss": {"limit": 0.1}}))
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run.records[0]['window_steps']\n")
    data = dict(BENCHMARK)
    data["configs"] = BENCHMARK["configs"] + [
        {"name": "vgg11", "source": "https://arxiv.org/abs/1409.1556",
         "file": "benchmark/configs/vgg11.json", "reduced": [],
         "why": "a test"}]
    data["workloads"] = BENCHMARK["workloads"] + [
        {"name": "vgg11.maxmin8.eager", "config": "vgg11",
         "traffic": "maxmin8.eager", "chips": 1, "why": "a test"}]
    data["per_layer"] = BENCHMARK["per_layer"] + [
        {"name": "steps_in_window", "unit": "steps", "better": "higher",
         "source": "host_clock", "layer": "device", "moves": "images_per_s",
         "workloads": ["vgg11.maxmin8.eager"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    cell = spec.load_cell("vgg11.maxmin8.eager", tmp_path, bench)
    assert cell.traffic["reducer"]["bits"] == 8
    assert cell.limits == {"loss": {"limit": 0.1}}
    assert cell.flops().forward_macs(cell.config) == 7_609_090_048
    assert "steps_in_window" in {m["name"] for m in cell.per_layer}
    reader = cell.reader("steps_in_window")
    assert reader.read(type("Run", (), {"records": [
        {"window_steps": 7}]})()) == 7
    # The same metric stays out of a cell it does not list.
    other = spec.load_cell("vgg16.maxmin4.eager", tmp_path, bench)
    assert "steps_in_window" not in {m["name"] for m in other.per_layer}


def test_peaks_match_by_words():
    assert spec.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert spec.peaks("NVIDIA H100 PCIe")["bytes_per_s"] == 2.0e12
    with pytest.raises(KeyError):
        spec.peaks("NVIDIA A100-SXM4-80GB")
