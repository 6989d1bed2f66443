"""On the card: a throwaway cell through the whole harness, the timed path
the port's kernels, held against the reference (``-m cuda``; skips on a
machine without one)."""

from __future__ import annotations

import pytest
import torch

from rfidbench.run import run

from .conftest import judged_run


@pytest.mark.cuda
def test_tiny_cells_correct_on_the_card(tiny_cell, tiny_miller_cell):
    """The FM0 cell is correct on the card.  In the Miller-4 one the
    reference, on the card, is what the synthesizer sent, and the port
    agrees with it but where it differs from what was sent as often, in
    slot verdicts alone (``faults_are_the_truths``): correct once the
    port's slot verdict agrees with the ground truth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    result = run(tiny_cell, 2 ** 31 + 1, 0.5, False, dev)
    assert result["correct"] and result["attempted"] > 0, result["checks"]
    assert result["device"]["platform"] == "gpu"
    result = judged_run(tiny_miller_cell, 2 ** 31 + 1, 0.5, dev)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert result["correct"] is (checks["truth_rows"] == 0), checks
