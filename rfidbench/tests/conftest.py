"""Helpers of the benchmark's own tests (``python -m pytest rfidbench/tests``,
on the CPU; ``-m cuda`` on the card).  They import neither JAX nor the JAX
package."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from rfidbench.cells import ROOT, load_cell

TINY_TRAFFIC = {"generator": "tiled_inventory", "tags": [{"id": 27, "seed": 7, "backscatter": None}],
                "rounds": 3, "tiles": 2, "captures": 2, "noise": 0.004}
TINY_WORKLOAD = {"reader": {"max_events": 64, "max_num_queries": 1000000},
                 "warmup_decodes": 3, "trace_decodes": 2, "limits": {"float_gap": 1e-3}}


def add_tiny_cell(root: Path, config: str) -> str:
    """A throwaway cell added the way a later change adds one: a traffic
    file, a workload file and entries in a copy of BENCHMARK.json, beside
    copies of the data files already there.  Returns the copy's path."""
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(ROOT / sub, root / sub, dirs_exist_ok=True)
    name = f"tiny.{config}"
    (root / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "workloads" / f"{name}.json").write_text(json.dumps(TINY_WORKLOAD))
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": "tiny",
                               "chips": 1, "why": "a throwaway cell of the tests"})
    path = root / f"BENCHMARK.{config}.json"
    path.write_text(json.dumps(bench))
    return str(path)


@pytest.fixture
def tiny_cell(tmp_path):
    """The throwaway FM0 cell, loaded by name from its files."""
    path = add_tiny_cell(tmp_path, "fm0_blf40_2msps")
    return load_cell("tiny.fm0_blf40_2msps", path, tmp_path)


@pytest.fixture
def tiny_miller_cell(tmp_path):
    path = add_tiny_cell(tmp_path, "miller4_blf40_2msps")
    return load_cell("tiny.miller4_blf40_2msps", path, tmp_path)
