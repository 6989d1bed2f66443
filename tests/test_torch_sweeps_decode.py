"""The slot-classifier and Miller-robustness twins
(``gen2_rfid_tpu_torch/tools/{classifier_sweep,miller_robustness_sweep}.py``)
against ``tools/``'s.

Every outcome here is an integer or a verdict: confusion counts, reads, the
exact flag.  So the port's ``Counter`` equals the JAX tool's, and the
printed tables on a narrowed grid (accuracies to two digits are counts over
the slots of a class; the Miller lines are JSON of integers and bools)
equal the JAX tool's line for line.
"""

import inspect
import json

import numpy as np
import pytest

from gen2_rfid_tpu_torch.tools import classifier_sweep, miller_robustness_sweep
from gen2_rfid_tpu_torch.tools.sweep import table_diff
from sweep_compare import jax_tool, keep_tf32_flags, run_jax_narrowed, run_port  # noqa: F401
from torch_compare import one_torch_thread  # noqa: F401


def test_cell_confusion_matches_jax():
    """tests/test_slots.py's collision cell (noise 0.064, pi/3 apart) at seed 3."""
    got = classifier_sweep.cell_confusion(0.064, np.pi / 3, seed=3, device="cpu")
    want = jax_tool("classifier_sweep").cell_confusion(0.064, np.pi / 3, seed=3)
    assert got == want
    assert sum(got.values()) > 0 and len({t for t, _ in got}) == 3


def test_classifier_table_matches_jax():
    """One noise and one phase separation, the tool's three seeds."""
    want = run_jax_narrowed(
        jax_tool("classifier_sweep"), "main",
        [("noises = [0.004, 0.016, 0.032, 0.064, 0.128, 0.192]", "noises = [0.016]"),
         ("dphis = [0.0, np.pi / 6, np.pi / 3, np.pi / 2, 2 * np.pi / 3, 5 * np.pi / 6]",
          "dphis = [np.pi / 2]")])
    got = run_port("classifier_sweep", ["--noises", "0.016", "--dphi-index", "3"])
    assert table_diff(got, want) == []
    assert len(got) == 3


def test_classifier_grid_is_the_jax_tools():
    src = inspect.getsource(jax_tool("classifier_sweep").main)
    assert f"noises = {list(classifier_sweep.NOISES)}" in src
    assert f"for seed in {classifier_sweep.SEEDS}:" in src
    assert classifier_sweep.DPHIS == (0.0, np.pi / 6, np.pi / 3, np.pi / 2,
                                      2 * np.pi / 3, 5 * np.pi / 6)


# The expected failure (Miller-2's 40 kHz subcarrier on the interferer) and
# a cell that must read every round (Miller-4, 300 Hz CFO, tracked).
@pytest.mark.parametrize("m,off,interf,cfo,exact", [
    (2, -0.04, True, False, False),
    (4, 0.04, False, True, True),
])
def test_miller_cell_matches_jax(m, off, interf, cfo, exact):
    onoff = {False: "off", True: "on"}
    want = run_jax_narrowed(
        jax_tool("miller_robustness_sweep"), "main",
        [("for m, (adc, decim) in GEOM.items():",
          f"for m, (adc, decim) in [({m}, GEOM[{m}])]:"),
         ("for off in (-0.04, 0.04):", f"for off in ({off},):"),
         ("for interf in (False, True):", f"for interf in ({interf},):"),
         ("for cfo in (False, True):", f"for cfo in ({cfo},):")])
    got = run_port("miller_robustness_sweep",
                   ["--m", str(m), "--blf-off", str(off), "--interferer", onoff[interf],
                    "--cfo", onoff[cfo]])
    assert table_diff(got, want) == []
    assert got[-1] == f'{{"summary": "{int(exact)}/1 exact"}}'
    assert json.loads(got[0])["exact"] is exact
    assert miller_robustness_sweep.cell(m, off, interf, cfo, device="cpu") == json.loads(got[0])
