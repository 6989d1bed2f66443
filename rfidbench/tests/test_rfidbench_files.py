"""BENCHMARK.json and the files it names: every piece loads by name, and a
cell is added by adding files and entries."""

from __future__ import annotations

import json
import re

import pytest
import torch

from rfidbench.cells import ROOT, generator, load_cell, metric_reader
from rfidbench.run import run

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rfidbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_loads(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((ROOT.parent / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"] == []
    assert cfg["precision"] == "float32"


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_loads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and len(entry["why"]) <= 200 and entry["chips"] == 1
    cell = load_cell(entry["name"], str(ROOT.parent / "BENCHMARK.json"))
    assert hasattr(generator(cell), "make")
    assert {m["name"] for m in cell.end_to_end} == {"capture_msps", "decode_p95_ms", "setup_s"}
    assert cell.workload["limits"]["float_gap"] > 0


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entry(entry):
    assert NAME.match(entry["name"]) and entry["better"] in ("lower", "higher")
    if "bound" in entry:
        assert 0.01 <= entry["bound"] <= 0.25 and entry["source"] in ("host_clock",
                                                                       "device_trace")
    else:
        assert callable(metric_reader(entry["name"]))
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_added_cell_runs(tiny_cell):
    """A throwaway cell, added as files and an entry, runs through the whole
    harness on the CPU (the look for a card skipped) and proves correct."""
    result = run(tiny_cell, 2 ** 31 + 11, 0.5, False, torch.device("cpu"))
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"capture_msps", "decode_p95_ms", "setup_s"}
