"""The trace arithmetic and the trace readers, on a synthetic trace."""

from __future__ import annotations

import json
import types

import pytest

import spec
import trace_read
from conftest import REPO

K = "kernel"


def test_union_length_and_minus():
    assert trace_read.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == \
        [(0, 4), (5, 6)]
    assert trace_read.length([(0, 2), (1, 3), (10, 11)]) == 4
    # [0, 10) less [2, 3) and [5, 12): 2 + 2.
    assert trace_read.minus([(0, 10)], [(2, 3), (5, 12)]) == 4
    assert trace_read.minus([(0, 1), (4, 6)], []) == 3
    assert trace_read.minus([(0, 1)], [(0, 1)]) == 0


def _event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


@pytest.fixture()
def synthetic(tmp_path):
    """A 100 µs window: a GEMM 0-40, NCCL 30-60 (10 µs exposed), B1 at
    70-80; the host in a sync from 60 to 100, idle before."""
    events = [
        _event(trace_read.WINDOW, "user_annotation", 1000, 100),
        _event("cudaStreamSynchronize", "cuda_runtime", 1060, 40),
        _event("aten::mm", "cpu_op", 990, 5),
        _event("sm90_gemm", K, 1000, 40, tid=7),
        _event("ncclDevKernel_AllReduce", K, 1030, 30, tid=8),
        _event("maxmin_quantize_kernel", K, 1070, 10, tid=7),
        _event("Memcpy HtoD", "gpu_memcpy", 1200, 5, tid=7),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace_read.digest(str(path))


def test_digest_clips_to_the_window_and_labels_gaps(synthetic):
    d = synthetic
    assert d["window_us"] == 100
    assert [e[0] for e in d["device"]] == ["sm90_gemm",
                                           "ncclDevKernel_AllReduce",
                                           "maxmin_quantize_kernel"]
    assert trace_read.length((e[2], e[3]) for e in d["device"]) == 70
    # Idle 60-70 and 80-100, the host in its sync both times.
    assert d["gaps"] == [["cudaStreamSynchronize", 30.0]]
    assert trace_read.top_ops(d["device"])[0] == ("sm90_gemm", 40.0)


def _run(trace, steps=1):
    cell = spec.load_cell("vgg16.maxmin4.eager.w4", REPO)
    record = {"rank": 0, "trace": trace, "traced_steps": steps,
              "host_ms": [3.0, 1.0, 2.0], "window_steps": 10,
              "window_s": 1.0, "step_ms": [1.0] * 10, "peak_bytes": 1,
              "setup_s": 5.0}
    run = types.SimpleNamespace(
        cell=cell, records=[record], world=1, batch=64,
        peaks=spec.peaks("NVIDIA H100 80GB HBM3"),
        flops_per_image=6 * 15_470_264_320,
        kernel_work=cell.kernel_work(),
        traces=lambda: [record["trace"]])
    return cell, run


def test_readers_on_the_synthetic_trace(synthetic):
    cell, run = _run(synthetic)
    read = {m: cell.reader(m).read(run) for m in
            ("device_idle_pct", "nccl_exposed_ms_per_step",
             "maxmin_ms_per_step", "host_ms_per_step", "step_mfu_pct")}
    assert read["device_idle_pct"] == pytest.approx(30.0)
    assert read["nccl_exposed_ms_per_step"] == pytest.approx(0.020)
    assert read["maxmin_ms_per_step"] == pytest.approx(0.010)
    assert read["host_ms_per_step"] == 2.0
    assert 0 < read["step_mfu_pct"]


def test_roofline_reads_nothing_when_the_launches_are_not_a_steps(
        synthetic):
    cell, run = _run(synthetic)
    assert cell.reader("maxmin_roofline_pct").read(run) is None


def test_roofline_over_whole_steps():
    cell, run = _run(None)
    work = run.kernel_work
    launches = work.step_launches(cell.config["params"], 4, 4, 512)
    device, t = [], 0.0
    names = {"maxmin_quantize": "maxmin_quantize_kernel",
             "maxmin_dequantize": "maxmin_decode_packed_kernel<false, 4>",
             "maxmin_dequantize_sum": "maxmin_decode_packed_kernel<true, 4>"}
    least = 0.0
    for wrapper, nbytes, ops in launches:
        us = 2e6 * work.least_seconds(nbytes, ops, run.peaks)  # at half
        least += us / 2
        device.append([names[wrapper], "kernel", t, t + us])
        t += us
    run.records[0]["trace"] = {"window_us": t, "device": device, "gaps": []}
    run.world = 4
    assert cell.reader("maxmin_roofline_pct").read(run) == \
        pytest.approx(50.0)
