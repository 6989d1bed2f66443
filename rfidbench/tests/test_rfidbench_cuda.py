"""On the card: a throwaway cell through the whole harness, the timed path
the port's kernels, held against the reference (``-m cuda``; skips on a
machine without one)."""

from __future__ import annotations

import pytest
import torch

from rfidbench.run import run


@pytest.mark.cuda
def test_tiny_cells_correct_on_the_card(tiny_cell, tiny_miller_cell):
    """The FM0 cell is correct on the card.  The Miller-4 one agrees with
    the reference everywhere and fails only the ground truth, by the
    slot verdict of each of its three rounds a capture (the program's
    fault that keeps Miller-4 out of BENCHMARK.json)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = run(tiny_cell, 2 ** 31 + 1, 0.5, False, torch.device("cuda", 0))
    assert result["correct"] and result["attempted"] > 0, result["checks"]
    assert result["device"]["platform"] == "gpu"
    checks = run(tiny_miller_cell, 2 ** 31 + 1, 0.5, False, torch.device("cuda", 0))["checks"]
    assert {k: v["value"] for k, v in checks.items() if k != "float_gap"} == {
        "event_rows": 0, "decode_rows": 0, "stats_fields": 0, "truth_rows": 6,
        "epc_misses": 0}, checks
    assert checks["float_gap"]["value"] < checks["float_gap"]["limit"]
