"""The harness loads neither JAX nor the JAX package, and the reference
loads nothing of the port; each checked in a fresh interpreter."""

from __future__ import annotations

import subprocess
import sys

from rfidbench.cells import ROOT

REPO = str(ROOT.parent)
FORBIDDEN = ("jax", "jaxlib", "flax", "gen2_rfid_tpu")


def loaded_roots(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_cpu_rehearsal_loads_no_jax(tmp_path):
    code = f"""
import torch
from rfidbench.tests.conftest import add_tiny_cell
from rfidbench.cells import load_cell
from rfidbench.run import run
from pathlib import Path
root = Path({str(tmp_path)!r})
cell = load_cell("tiny.fm0_blf40_2msps", add_tiny_cell(root, "fm0_blf40_2msps"), root)
assert run(cell, 9, 0.2, False, torch.device("cpu"))["correct"]
"""
    roots = loaded_roots(code)
    assert "gen2_rfid_tpu_torch" in roots and not roots & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    roots = loaded_roots("import rfidbench.reference.decode, rfidbench.judge, "
                         "rfidbench.traffic.tiled_inventory")
    assert not roots & set(FORBIDDEN + ("gen2_rfid_tpu_torch",))


def test_no_result_without_a_card():
    """Without CUDA the command prints nothing on standard output and exits
    non-zero; it never falls back to the CPU."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "rfidbench.run", "--workload",
                          "fm0.one_tag_2min", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
