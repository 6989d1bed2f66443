"""The SIC sweeps' twin (``gen2_rfid_tpu_torch/tools/sic_sweep.py``)
against ``tools/sic_sweep.py``, the window and the SIC held apart.

* The captures are the JAX tool's numpy draws: equal.
* The port's window (its matched filter, then the DC mean and slice in
  numpy) agrees with the JAX tool's window (XLA's convolution) within
  ``FIR_ATOL`` = 3e-5: the two filters add the same 25 terms in another
  float32 order, and at a y of 16-32 (the carrier's 25 taps) each addition
  may round by half an ulp of 2**-19, 25 of them 2.4e-5 at worst; the DC
  subtracted is a mean of such y.  Measured here: 1.1e-5.
* On the JAX window, the port's ``rn16_sic`` / ``epc_sic`` give the JAX
  package's bits (and CRC verdicts): equal.
* Each trial's verdict on each package's own window is equal, and the
  printed tables on a narrowed grid equal the JAX tool's line for line.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp.collision import epc_sic as ref_epc_sic
from gen2_rfid_tpu.dsp.collision import rn16_sic as ref_rn16_sic
from gen2_rfid_tpu.dsp.filters import boxcar_taps as ref_boxcar_taps
from gen2_rfid_tpu.dsp.filters import matched_filter_decimate as ref_mfd
from gen2_rfid_tpu_torch.dsp.collision import epc_sic, rn16_sic
from gen2_rfid_tpu_torch.tools import sic_sweep as tool
from gen2_rfid_tpu_torch.tools.sweep import table_diff
from sweep_compare import jax_tool, keep_tf32_flags, run_jax_narrowed, run_port  # noqa: F401
from torch_compare import one_torch_thread  # noqa: F401

REF_CFG = RefConfig()
FIR_ATOL = 3e-5
# The JAX references jitted whole (the tool runs them op by op; the same
# package's arithmetic, each window one compile of its shape).
ref_rn16_sic_jit = jax.jit(lambda w: ref_rn16_sic(w, REF_CFG))
ref_epc_sic_jit = jax.jit(lambda w: ref_epc_sic(w, REF_CFG))


def jax_window(x, n_window):
    """The JAX tool's window (tools/sic_sweep.py:38-42)."""
    y = np.asarray(ref_mfd(jnp.asarray(x), ref_boxcar_taps(25), REF_CFG.decim))
    dc = y[300:348].mean()
    start = 400 + int(round(252.5 * tool.SP_US)) // 5 - 4
    return y[start:start + n_window + 8] - dc


def test_sweep_constants_are_the_jax_tools():
    assert tool.SP_US == REF_CFG.adc_rate / 1e6
    assert (tool.CFG.rn16_window, tool.CFG.epc_window) == (REF_CFG.rn16_window,
                                                           REF_CFG.epc_window)


# One cell of each sweep at the weakest collider: ratio 0.1 at 15 dB, where
# a trial can sit on the filters' residue, and ratio 0.15 at noise 0.02.
@pytest.mark.parametrize("dt1", [0.0, 5.0])
def test_rn16_cell_matches_jax(dt1):
    verdicts = []
    for trial in range(tool.N_TRIALS):
        x, b1, b2 = tool.rn16_draw(0.1, dt1, 15.0, trial)
        want_w = jax_window(x, REF_CFG.rn16_window)
        got_w = tool.matched_window(x, tool.CFG.rn16_window, "cpu").numpy()
        np.testing.assert_allclose(got_w, want_w, rtol=0, atol=FIR_ATOL)
        # The SIC on the same (JAX) window: the same bits.
        ref = ref_rn16_sic_jit(jnp.asarray(want_w))
        got = rn16_sic(torch.from_numpy(want_w), tool.CFG)
        np.testing.assert_array_equal(got.bits1.numpy(), np.asarray(ref.bits1))
        np.testing.assert_array_equal(got.bits2.numpy(), np.asarray(ref.bits2))
        # Each package's own window: the same verdict.
        want_ok = (np.array_equal(np.asarray(ref.bits1), b1)
                   and np.array_equal(np.asarray(ref.bits2), b2))
        assert tool.rn16_trial(0.1, dt1, 15.0, trial, device="cpu") == want_ok, trial
        verdicts.append(want_ok)
    assert 0 < sum(verdicts) < tool.N_TRIALS      # the cell is on its edge


def test_epc_cell_matches_jax():
    verdicts = []
    for s in range(tool.EPC_TRIALS):
        x, t1, t2 = tool.epc_draw(0.15, 2.5, 0.02, s)
        want_w = jax_window(x, REF_CFG.epc_window)
        got_w = tool.matched_window(x, tool.CFG.epc_window, "cpu").numpy()
        np.testing.assert_allclose(got_w, want_w, rtol=0, atol=FIR_ATOL)
        ref = ref_epc_sic_jit(jnp.asarray(want_w))
        got = epc_sic(torch.from_numpy(want_w), tool.CFG)
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
        np.testing.assert_array_equal(got.crc_ok.numpy(), np.asarray(ref.crc_ok))
        want = {tuple(int(v) for v in t.epc_frame_bits()) for t in (t1, t2)}
        have = {tuple(int(v) for v in fr)
                for fr, o in zip(np.asarray(ref.bits), np.asarray(ref.crc_ok)) if o}
        assert tool.epc_trial(0.15, 2.5, 0.02, s, device="cpu") == (want <= have), s
        verdicts.append(want <= have)
    assert sum(verdicts) >= 1


def test_rn16_table_matches_jax():
    want = run_jax_narrowed(jax_tool("sic_sweep"), "main",
                            [("ratios = [1.0, 0.7, 0.4, 0.2, 0.1]", "ratios = [0.1]"),
                             ("n_trials = 12", "n_trials = 4")])
    got = run_port("sic_sweep", ["--ratios", "0.1", "--trials", "4"])
    assert table_diff(got, want) == []
    assert len(got) == 2 + 6


def test_epc_table_matches_jax():
    want = run_jax_narrowed(jax_tool("sic_sweep"), "epc_sweep",
                            [("ratios = (1.0, 0.7, 0.4, 0.15)", "ratios = (0.15,)"),
                             ("trials = 8", "trials = 3")])
    got = run_port("sic_sweep", ["--epc", "--ratios", "0.15", "--trials", "3"])
    assert table_diff(got, want) == []
    assert len(got) == 3
