"""The impairment and ranging twins
(``gen2_rfid_tpu_torch/tools/{impair_sweep,ranging_sweep}.py``) against
``tools/``'s.

* ``read_frac`` is reads over rounds, integer counts: equal, and the
  narrowed impairment table equals the JAX tool's line for line.
* Ranging fits phases of the decodes' channel estimates, which agree to
  1e-4 of their largest magnitude (``torch_compare``), so a phase to 1e-4
  rad.  Over a 12.5-25 MHz span a phase slope error of 1e-4 rad moves the
  range by c / (4 pi span) x 1e-4, under 0.2 mm: ranges agree within
  ``RANGE_ATOL`` = 1 mm, the fit residual within 1e-3 rad, and a velocity
  (a phase slope over 75 ms at 915 MHz) within ``VEL_ATOL`` = 1e-3 m/s.
  The printed lines (cm to two digits) may differ by one unit of their
  last digit.
"""

import numpy as np
import pytest

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.runtime.inventory import decode_capture as ref_decode_capture
from gen2_rfid_tpu.runtime.ranging import estimate_velocity as ref_estimate_velocity
from gen2_rfid_tpu.runtime.ranging import range_from_captures as ref_range
from gen2_rfid_tpu.runtime.ranging import tag_phase_series as ref_phase_series
from gen2_rfid_tpu.sim.impairments import RxImpairments as RefImpairments
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import synthesize_inventory as ref_synthesize
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.runtime.ranging import range_from_captures
from gen2_rfid_tpu_torch.tools import impair_sweep, ranging_sweep
from gen2_rfid_tpu_torch.tools.sweep import table_diff
from sweep_compare import jax_tool, keep_tf32_flags, run_jax_narrowed, run_port  # noqa: F401
from torch_compare import one_torch_thread  # noqa: F401

RANGE_ATOL = 1e-3
VEL_ATOL = 1e-3


# ---- impairments -----------------------------------------------------------------

def test_read_frac_matches_jax_tracked_phase_walk():
    """The tool's three seeds on its most delicate axis: a 5e-3 rad/sample
    LO walk, decoded with channel tracking."""
    got = impair_sweep.read_frac(ReaderConfig(max_events=64),
                                 impair_sweep.RxImpairments(phase_walk_rad=5e-3),
                                 track=True, device="cpu")
    want = jax_tool("impair_sweep").read_frac(RefConfig(max_events=64),
                                              RefImpairments(phase_walk_rad=5e-3), track=True)
    assert got == want


def test_impair_table_matches_jax(monkeypatch):
    """One point on each axis (both interferer offsets), at seed 1."""
    tool = jax_tool("impair_sweep")
    monkeypatch.setattr(tool, "SEEDS", (1,))
    want = run_jax_narrowed(tool, "main", [
        ("for bits in (12, 10, 8, 7, 6, 5):", "for bits in (6,):"),
        ("for g, p in ((0.2, 1.0), (0.5, 3.0), (1.0, 6.0), (2.0, 10.0), (3.0, 20.0)):",
         "for g, p in ((2.0, 10.0),):"),
        ("for s in (1e-3, 2e-3, 4e-3, 5e-3, 6e-3, 8e-3):", "for s in (6e-3,):"),
        ("for dbc in (-40, -30, -25, -20, -15, -10):", "for dbc in (-15,):")])
    got = run_port("impair_sweep", ["--quant-bits", "6", "--iq-index", "3",
                                       "--phase-walk", "6e-3", "--interferer-dbc", "-15",
                                       "--seeds", "1"])
    assert table_diff(got, want) == []
    assert len(got) == 4 + 1 + 1 + 1 + 2


def test_impair_grid_is_the_jax_tools():
    import inspect

    src = inspect.getsource(jax_tool("impair_sweep").main)
    for text in (f"for bits in {impair_sweep.QUANT_BITS}:", f"for g, p in {impair_sweep.IQ}:",
                 f"for dbc in {impair_sweep.INTERFERER_DBC}:"):
        assert text in src, text
    assert "for s in (1e-3, 2e-3, 4e-3, 5e-3, 6e-3, 8e-3):" in src
    assert impair_sweep.PHASE_WALK == (1e-3, 2e-3, 4e-3, 5e-3, 6e-3, 8e-3)


# ---- ranging -------------------------------------------------------------------------

def two_hops():
    n = ranging_sweep.FCC_HOP_FREQS_HZ
    return n[:: max(len(n) // 2, 1)][:2]


def test_range_from_captures_at_two_hops_matches_jax():
    """sweep_hops's first trial at 2 hops: the same reads a capture, the
    range and residual within tolerance."""
    freqs = two_hops()
    got = ranging_sweep.hop_captures(freqs, 3.7, seed0=200, device="cpu")
    want = jax_tool("ranging_sweep").hop_captures(freqs, 3.7, seed0=200)
    for (fg, sg), (fw, sw) in zip(got, want):
        assert fg == fw and sorted(sg) == sorted(sw) == [27]
        np.testing.assert_array_equal(sg[27]["time_s"], sw[27]["time_s"])
        np.testing.assert_allclose(sg[27]["phase_rad"], sw[27]["phase_rad"], rtol=0, atol=1e-4)
    est, ref = range_from_captures(got)[27], ref_range(want)[27]
    assert abs(est["range_m"] - ref["range_m"]) <= RANGE_ATOL
    assert abs(est["resid_rad"] - ref["resid_rad"]) <= 1e-3
    assert abs(est["range_m"] - 3.7) < 0.01


def test_velocity_estimate_matches_jax():
    """sweep_velocity's first trial at 5 rounds (tools/ranging_sweep.py:81-88)."""
    cfg = RefConfig()
    tr = ref_synthesize(cfg, [RefTag.with_id(27, seed=7, distance_m=2.0, velocity_mps=1.5)],
                        n_rounds=5, seed=700)
    _, dec = ref_decode_capture(tr.iq, cfg)
    s = ref_phase_series(dec, cfg)[27]
    want = abs(ref_estimate_velocity(s["time_s"], s["phase_rad"], cfg.freq_hz)
               ["velocity_mps"] - 1.5)
    got = ranging_sweep.velocity_error(5, 0, device="cpu")
    assert abs(got - want) <= VEL_ATOL
    assert got < 0.05


@pytest.mark.parametrize("sweep,argv,edits", [
    ("sweep_hops", ["--hops", "2", "--trials", "1"],
     [("for n_hops in (2, 3, 5, 10):", "for n_hops in (2,):"),
      ("for trial in range(5):", "for trial in range(1):")]),
    ("sweep_velocity", ["--rounds", "5", "--trials", "1"],
     [("for n_rounds in (5, 10, 20, 40):", "for n_rounds in (5,):"),
      ("for trial in range(3):", "for trial in range(1):")]),
])
def test_ranging_table_matches_jax(sweep, argv, edits):
    want = run_jax_narrowed(jax_tool("ranging_sweep"), sweep, edits)
    name = {"sweep_hops": "hops", "sweep_velocity": "velocity"}[sweep]
    got = run_port("ranging_sweep", ["--sweeps", name] + argv)
    assert table_diff(got, want, last_digits=1) == []
    assert len(got) == 2
