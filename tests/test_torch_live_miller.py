"""The port's closed-loop live reader against the JAX package's, on the CPU:
Miller-4 (FM0 in ``tests/test_torch_live.py``).

The window decoder on every Miller-4 window decode of two JAX loops, in
every mode, and with ``epc_softfix``; and those two loops whole.
``tests/live_compare.py`` says what is compared and to what tolerance.
"""

import pytest

import live_compare as lc
from torch_compare import one_torch_thread  # noqa: F401

# access_m4: a SIC reader's sic / epc_sic windows and access replies at
# Miller-4; ladder: FM0 -> Miller-2 -> Miller-4 under a -20 dBc interferer
# at the tags' 40 kHz, so Miller-4's rn16 / epc windows carry the tone.
RECORDED = ("access_m4", "ladder")


@pytest.fixture(scope="module")
def recorded():
    return lc.record(RECORDED)


@pytest.mark.parametrize("mode", lc.MODES)
def test_window_decoder_matches_jax(recorded, mode):
    lc.check_window_decoder(recorded[1], 4, mode)


def test_window_decoder_softfix_matches_jax(recorded):
    lc.check_softfix(recorded[1], 4, sigmas=(0.035, 0.04, 0.045))


@pytest.mark.parametrize("name", RECORDED)
def test_live_loop_matches_jax(recorded, name):
    lc.check_loop(recorded[0], name)


def test_live_scenes_hold_their_tests_counts(recorded):
    """access_m4 reads back what it writes; the ladder walks FM0 -> M2 ->
    M4 (tests/test_link_adapt.py:73)."""
    runs = recorded[0]
    st = runs["access_m4"][1]
    assert st.n_write_ok == 2 and st.n_read_ok == 2
    st = runs["ladder"][1]
    assert [m for _, m in st.link_trace] == [2, 4] and runs["ladder"][0].cfg.miller_m == 4
