"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic (``traffic/<traffic>.json``
and the generator module that file names), its workload file
(``workloads/<cell>.json``) and the per-layer readers (``metrics/<metric>.py``).
A cell, configuration, traffic or metric is added by adding its files and
its entry; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    workload: dict       # workloads/<name>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark_path: str = "BENCHMARK.json", root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``benchmark_path``, its data files under ``root``."""
    bench = _json(Path(benchmark_path))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {benchmark_path}: {sorted(entries)}")
    entry = entries[name]

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name, entry, _json(root / "configs" / f"{entry['config']}.json"),
                _json(root / "traffic" / f"{entry['traffic']}.json"),
                _json(root / "workloads" / f"{name}.json"),
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def reader_fields(cell: Cell) -> Dict:
    """The ReaderConfig fields the cell runs with: the configuration's
    fields, the values it assumes, then the workload's capacities."""
    assumed = {k: v for k, v in cell.config.get("assumed", {}).items() if k != "why"}
    return {**cell.config["reader_config"], **assumed, **cell.workload.get("reader", {})}


def generator(cell: Cell):
    return importlib.import_module(f"rfidbench.traffic.{cell.traffic['generator']}")


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``, loaded by its path (a metric's name
    may hold dots)."""
    path = ROOT / "metrics" / f"{name}.py"
    mod_name = "rfidbench.metrics." + name.replace(".", "__").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
