"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``) with the slot rule it gives the
reference and the keywords it gives the synthesizer, its traffic
(``traffic/<traffic>.json`` and the generator module that file names), its
workload file (``workloads/<cell>.json``) and the per-layer readers
(``metrics/<metric>.py``).  A cell, configuration, traffic or metric is
added by adding its files and its entry; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

from .reference.decode import SlotRule

ROOT = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    workload: dict       # workloads/<name>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    slot_rule: SlotRule  # the configuration's ``slot_rule``, the reference's slot verdict
    synthesizer: Dict    # the configuration's ``synthesizer`` keywords


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)


def slot_rule(config: dict, path: Path) -> SlotRule:
    """The configuration's top-level ``slot_rule``: ``margin_min`` and
    ``excess`` ([low, high], in |h|^2), and an optional ``why``.  A
    configuration without one gets ``SlotRule()``, the rule fitted to FM0.
    A rule with an unknown key, a missing or non-finite number, or
    ``excess`` not a pair with low <= high is refused, naming ``path``."""
    spec = config.get("slot_rule")
    if spec is None:
        return SlotRule()
    if not isinstance(spec, dict):
        raise ValueError(f"{path}: slot_rule is not an object")
    unknown = sorted(set(spec) - set(SlotRule._fields) - {"why"})
    missing = sorted(set(SlotRule._fields) - set(spec))
    if unknown or missing:
        raise ValueError(f"{path}: slot_rule has unknown keys {unknown}, misses {missing}")
    excess = spec["excess"]
    if not (_number(spec["margin_min"]) and isinstance(excess, list) and len(excess) == 2
            and all(map(_number, excess))):
        raise ValueError(f"{path}: slot_rule needs finite numbers margin_min and "
                         f"excess [low, high]: {spec}")
    if excess[0] > excess[1]:
        raise ValueError(f"{path}: slot_rule's excess {excess} has low > high")
    return SlotRule(float(spec["margin_min"]), (float(excess[0]), float(excess[1])))


SYNTH_KEYS = ("tag_t1_us",)


def synthesizer(config: dict, path: Path) -> Dict:
    """The configuration's top-level ``synthesizer``: keywords the traffic
    generator hands the synthesizer, ``tag_t1_us`` (how long after the
    reader's command a tag starts its reply, in us), and an optional
    ``why``.  A configuration without one keeps the synthesizer's defaults.
    An unknown key, or a value that is not a finite number above 0, is
    refused, naming ``path``."""
    spec = config.get("synthesizer", {})
    if not isinstance(spec, dict):
        raise ValueError(f"{path}: synthesizer is not an object")
    unknown = sorted(set(spec) - set(SYNTH_KEYS) - {"why"})
    if unknown:
        raise ValueError(f"{path}: synthesizer has unknown keys {unknown}")
    out = {k: spec[k] for k in SYNTH_KEYS if k in spec}
    if not all(_number(v) and v > 0 for v in out.values()):
        raise ValueError(f"{path}: synthesizer needs finite numbers above 0: {spec}")
    return {k: float(v) for k, v in out.items()}


def load_cell(name: str, benchmark_path: str = "BENCHMARK.json", root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``benchmark_path``, its data files under ``root``."""
    bench = _json(Path(benchmark_path))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {benchmark_path}: {sorted(entries)}")
    entry = entries[name]

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    config_path = root / "configs" / f"{entry['config']}.json"
    config = _json(config_path)
    return Cell(name, entry, config, _json(root / "traffic" / f"{entry['traffic']}.json"),
                _json(root / "workloads" / f"{name}.json"),
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)],
                slot_rule(config, config_path), synthesizer(config, config_path))


def reader_fields(cell: Cell) -> Dict:
    """The ReaderConfig fields the cell runs with: the configuration's
    fields, the values it assumes, then the workload's capacities."""
    assumed = {k: v for k, v in cell.config.get("assumed", {}).items() if k != "why"}
    return {**cell.config["reader_config"], **assumed, **cell.workload.get("reader", {})}


def generator(cell: Cell):
    return importlib.import_module(f"rfidbench.traffic.{cell.traffic['generator']}")


def captures(cell: Cell, scfg, seed: int, dev) -> list:
    """The cell's captures at ``seed``: its traffic's generator under the
    synthesizer's reader configuration ``scfg``, given the configuration's
    ``synthesizer`` keywords."""
    return generator(cell).make(cell.traffic, scfg, seed, dev, **cell.synthesizer)


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``, loaded by its path (a metric's name
    may hold dots)."""
    path = ROOT / "metrics" / f"{name}.py"
    mod_name = "rfidbench.metrics." + name.replace(".", "__").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
