"""Helpers of the benchmark's own tests (``python -m pytest rfidbench/tests``,
on the CPU; ``-m cuda`` on the card).  They import neither JAX nor the JAX
package."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from rfidbench import judge
from rfidbench.cells import ROOT, captures, load_cell, slot_rule, synthesizer

MILLER = "miller4_blf160_2msps"
# The InventoryStats fields the replay (the reference's and the port's)
# derives from slot_state: the only ones a slot verdict moves.
SLOT_STATS = ("n_slot_empty", "n_slot_single", "n_slot_collision")

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
    path = add_tiny_cell(tmp_path, MILLER)
    return load_cell(f"tiny.{MILLER}", path, tmp_path)


def file_config(name: str):
    """(the reader fields, the slot rule, the synthesizer keywords) of
    ``configs/<name>.json``."""
    path = ROOT / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text())
    assumed = {k: v for k, v in cfg.get("assumed", {}).items() if k != "why"}
    return {**cfg["reader_config"], **assumed}, slot_rule(cfg, path), synthesizer(cfg, path)


def faults_are_the_truths(got, want, truth, limits) -> dict:
    """The harness's invariant, which holds before and after a repair of the
    program's slot verdict: the reference is what was sent; the program
    equals it in events, floats and EPC count; where the program's decoded
    rows differ from the reference's they differ from what was sent as
    often, and only the stats the replay derives from slot_state differ.
    ``truth_rows`` has to see a verdict turned: each row the reference
    calls single, called a collision, counts once.  Returns the capture's
    checks."""
    assert judge.truth_rows(want[1], truth) == 0
    single = want[1].slot_state == 1
    turned = want[1]._replace(slot_state=torch.where(single, 2, want[1].slot_state))
    assert 0 < int(single.sum()) == judge.truth_rows(turned, truth)
    c = judge.compare(*got, *want, truth)
    assert c["event_rows"] == 0 and c["float_gap"] < limits["float_gap"], c
    assert int(got[0].n_epc_correct) == int(want[0].n_epc_correct)
    assert c["decode_rows"] == c["truth_rows"], c
    differ = {f for f in judge.STATS_FIELDS
              if not torch.equal(getattr(got[0], f).cpu(), getattr(want[0], f).cpu())}
    assert differ <= set(SLOT_STATS) and (c["decode_rows"] > 0 or not differ), differ
    return c


def judged_run(cell, seed: int, seconds: float, dev, wrap=None) -> dict:
    """A run of ``cell`` through the port's own entry, or through
    ``wrap(entry, scfg)`` where given (``scfg`` the synthesizer's reader
    configuration), held to ``faults_are_the_truths`` capture by capture:
    the last output the run kept of each capture against the reference
    under the configuration's rule.  The run's own checks must be the worst
    of these.  Returns the run's result."""
    from rfidbench.reference.decode import decode_capture
    from rfidbench.run import program, run

    _, scfg, entry = program(cell, dev)
    if wrap is not None:
        entry = wrap(entry, scfg)
    last = {}

    def decode(x2):
        out = entry(x2)
        last[x2.data_ptr()] = (x2, out)
        return out

    result = run(cell, seed, seconds, False, dev, decode=decode)
    per_capture = []
    for cap in captures(cell, scfg, seed, dev):
        (got,) = [out for x2, out in last.values() if torch.equal(x2, cap.x2)]
        want = decode_capture(cap.x2, scfg, slot_rule=cell.slot_rule)
        per_capture.append(faults_are_the_truths(got, want, cap.truth,
                                                 cell.workload["limits"]))
    checks = result["checks"]
    for name in ("event_rows", "decode_rows", "stats_fields", "truth_rows"):
        assert checks[name]["value"] == max(c[name] for c in per_capture), (name, checks)
    assert checks["epc_misses"]["value"] == 0, checks
    return result
