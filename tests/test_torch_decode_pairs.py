"""tools/decode_pairs.py's order of runs and its summary, on made-up times
(the runs themselves need the card)."""

import pytest

from gen2_rfid_tpu_torch.tools.decode_pairs import CASES, order, summarize


def test_runs_go_before_after_after_before():
    assert order(2) == ["before", "after", "after", "before"] * 2


@pytest.mark.parametrize("after_ms, won", [(9.0, 2), (11.0, 0)])
def test_summary_splits_sides_and_blocks(after_ms, won):
    sides = order(2)
    ms = {"before": [10.0, 12.0, 10.0, 12.0], "after": [after_ms] * 4}
    taken = {"before": 0, "after": 0}
    runs = []
    for side in sides:
        runs.append({"c": {"ms": ms[side][taken[side]], "epcs": 1}})
        taken[side] += 1
    row = summarize(sides, runs)["c"]
    assert row["before"] == ms["before"] and row["after"] == ms["after"]
    assert row["block_diff_ms"] == [after_ms - 11.0] * 2
    assert (row["after_won"], row["blocks"]) == (won, 2)


def test_cases_are_chip_smokes_captures():
    import chip_smoke

    high = {name: (kw, rounds) for name, kw, rounds in chip_smoke.HIGH_RATES}
    miller = {m[0]: m for m in chip_smoke.MILLER_BENCH}
    for name, kw, rounds, tiles in CASES:
        if name in high:
            assert (kw, rounds, tiles) == (*high[name], 2)
        elif name == "compat_bench":
            assert kw == {"mode": "compat", "max_events": 1536}
            assert (rounds, tiles) == (chip_smoke.BENCH_ROUNDS, chip_smoke.BENCH_TILES)
        else:
            assert kw == miller[name][1] and tiles == miller[name][2]
