"""The per-layer readers on a hand-made trace, and a traced CPU run."""

from __future__ import annotations

import json

import pytest
import torch

from rfidbench import roofline
from rfidbench.cells import metric_reader
from rfidbench.run import run
from rfidbench.trace import read_chrome_trace


def write_trace(path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "rfidbench.stretch", "ts": 100.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "ts": 100.0, "dur": 200.0,
         "name": "(anonymous namespace)::gate_front_y_kernel(float const*, long long)"},
        {"ph": "X", "cat": "kernel", "ts": 250.0, "dur": 100.0,
         "name": "(anonymous namespace)::stream_kernel(float const*, long long, float)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 600.0, "dur": 100.0, "name": "Memcpy DtoH"},
        {"ph": "X", "cat": "kernel", "ts": 2000.0, "dur": 100.0, "name": "outside"},
        {"ph": "X", "cat": "cpu_op", "ts": 380.0, "dur": 200.0, "name": "aten::item"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 700.0, "dur": 350.0, "name": "cudaStreamSynchronize"},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))


def test_readers_on_a_hand_made_trace(tmp_path):
    path = tmp_path / "t.json"
    write_trace(path)
    tr = read_chrome_trace(str(path), decodes=2)
    tr.shapes = {"n": 1000, "ny": 200, "taps": 25, "win": 100}
    assert len(tr.device) == 3 and tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(350e-6)
    assert metric_reader("device_idle_pct")(tr) == pytest.approx(65.0)
    assert metric_reader("device_ops_per_decode")(tr) == pytest.approx(1.5)
    want = 100 * roofline.front_y_bound(1000, 200, 25).seconds / 200e-6
    assert metric_reader("gate_front_y_roofline")(tr) == pytest.approx(want)
    want = 100 * roofline.stack_bound(200, 100).seconds / 100e-6
    assert metric_reader("gate_stack_roofline")(tr) == pytest.approx(want)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].endswith("gate_front_y_kernel(float const*, long long)")
    assert bd["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(400e-6)]
    assert bd["idle_gaps"][1] == ["aten::item", pytest.approx(250e-6)]


def test_readers_find_nothing_in_an_empty_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "rfidbench.stretch", "ts": 0.0,
         "dur": 10.0}]}))
    tr = read_chrome_trace(str(path), decodes=1)
    for name in ("device_idle_pct", "device_ops_per_decode", "gate_front_y_roofline",
                 "gate_stack_roofline"):
        assert metric_reader(name)(tr) is None


def test_traced_run_on_the_cpu(tiny_cell):
    """With no device ops to read the readers leave every metric out; the
    line still judges the traced decodes."""
    result = run(tiny_cell, 3, 0.3, True, torch.device("cpu"))
    assert result["correct"] and result["metrics"] == {} and result["attempted"] == 2
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"
