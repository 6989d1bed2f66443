"""The envelope sweeps' twins (``gen2_rfid_tpu_torch/tools/``) against the
root ``tools/`` scripts: the SNR waterfall, the SNR table, the softfix
false-accept campaign, ``wilson_upper``, the refusal without CUDA and the
table comparison the card's runs use.

* ``waterfall_db`` takes the JAX package's bisection path, so it returns
  the same float (equal).
* The softfix campaign is integer logic on the JAX tool's seeded numpy
  draws: the counts, and so the JSON lines, are equal.
* ``wilson_upper`` is the JAX tool's numpy arithmetic: equal floats.
* The printed tables on a narrowed grid equal the JAX tool's line for line
  (EPC rates are integer counts over the expected EPCs; the waterfall is
  a bisection of dB values).
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.sim import snr as ref_snr
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.sim import snr
from gen2_rfid_tpu_torch.tools import (
    classifier_sweep, impair_sweep, miller_robustness_sweep, ranging_sweep, sic_sweep,
    snr_curves, softfix_false_accept)
from gen2_rfid_tpu_torch.tools.sweep import table_diff
from sweep_compare import jax_tool, keep_tf32_flags, run_jax_narrowed, run_port  # noqa: F401
from torch_compare import one_torch_thread  # noqa: F401

TWINS = [snr_curves, softfix_false_accept, sic_sweep, classifier_sweep,
         miller_robustness_sweep, impair_sweep, ranging_sweep]


# ---- the waterfall -------------------------------------------------------------

def test_waterfall_db_matches_jax_at_fm0():
    """A coarse bisection (2 dB, 4 rounds): every probe's verdict equal, so
    the same float."""
    kw = dict(lo_db=-6.0, hi_db=16.0, tol_db=2.0, n_rounds=4)
    got = snr.waterfall_db(ReaderConfig(max_events=64), device="cpu", **kw)
    want = ref_snr.waterfall_db(RefConfig(max_events=64), **kw)
    assert got == want
    assert -6.0 < got < 16.0


def test_waterfall_db_device_is_keyword_only_and_cuda_by_default(monkeypatch):
    par = inspect.signature(snr.waterfall_db).parameters["device"]
    assert par.kind is inspect.Parameter.KEYWORD_ONLY and par.default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snr.waterfall_db(ReaderConfig(max_events=64), n_rounds=1)


def test_snr_curves_table_matches_jax():
    """FM0 at one SNR point, then its waterfall at the tool's 0.25 dB."""
    want = run_jax_narrowed(
        jax_tool("snr_curves"), "main",
        [("grid = np.arange(-4.0, 16.1, 2.0)", "grid = np.array([10.0])"),
         ("for name, cfg in MODES.items():",
          "for name, cfg in [('fm0_blf40', MODES['fm0_blf40'])]:")])
    got = run_port("snr_curves", ["--modes", "fm0_blf40", "--snr", "10"])
    assert table_diff(got, want) == []
    assert len(got) == 4 and got[-1].startswith("| fm0_blf40 | ")


def test_snr_curves_modes_are_the_jax_tools():
    ref = jax_tool("snr_curves").MODES
    assert list(snr_curves.MODES) == list(ref)
    for name, cfg in snr_curves.MODES.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[name]), name


# ---- the softfix campaign ------------------------------------------------------

SOFTFIX_SEED = 1      # a seed where one batch of 4,096 frames has accepts in both modes


def test_softfix_campaign_matches_jax():
    """One batch of 4,096 frames at seed 1 in both modes: the JAX tool's
    JSON lines, and at least one false accept in each."""
    argv = ["--frames", "4096", "--seed", str(SOFTFIX_SEED)]
    want = run_jax_narrowed(jax_tool("softfix_false_accept"), "main", argv=argv)
    got = run_port("softfix_false_accept", argv)
    assert table_diff(got, want) == []
    accepts = {r["mode"]: r["false_accepts"] for r in map(json.loads, got)}
    assert accepts["native"] >= 1 and accepts["compat"] >= 1, accepts


@pytest.mark.parametrize("mode", ["native", "compat"])
def test_softfix_counts_in_smaller_batches(mode):
    """Batches of 1,000 frames draw another sequence: its count, batch by
    batch summed, is the JAX tool's at that batch size too."""
    argv = ["--frames", "3000", "--batch", "1000", "--seed", "4"]
    want = [line for line in run_jax_narrowed(jax_tool("softfix_false_accept"), "main",
                                              argv=argv) if f'"{mode}"' in line]
    got = run_port("softfix_false_accept", argv + ["--modes", mode])
    assert table_diff(got, want) == []


@pytest.mark.parametrize("k,n", [(0, 0), (0, 200_704), (8, 200_704), (104, 200_704),
                                 (3, 7), (5, 5)])
def test_wilson_upper_matches_jax(k, n):
    assert softfix_false_accept.wilson_upper(k, n) == jax_tool(
        "softfix_false_accept").wilson_upper(k, n)


# ---- every twin: the device policy ----------------------------------------------

@pytest.mark.parametrize("twin", TWINS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_twin_refuses_without_cuda(twin, monkeypatch):
    """Without CUDA and without ``--device cpu`` a twin raises before it
    runs anything; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])


def test_twin_functions_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: softfix_false_accept.false_accepts("native", 1, 1),
        lambda: sic_sweep.rn16_trial(1.0, 0.0, 30.0, 0),
        lambda: miller_robustness_sweep.cell(4, 0.04, False, False),
        lambda: impair_sweep.read_frac(ReaderConfig(max_events=64),
                                      impair_sweep.RxImpairments(), seeds=(1,)),
        lambda: ranging_sweep.velocity_error(5, 0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_main_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    run_port("softfix_false_accept", ["--frames", "1", "--batch", "1"])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# ---- the table comparison -----------------------------------------------------------

def test_table_diff():
    line = "hops= 2 span= 2.50e+07 Hz median|err|=1.23 cm max=4.56 cm"
    assert table_diff([line], [line]) == []
    near = line.replace("1.23", "1.24")
    assert table_diff([near], [line]) != []               # exact by default
    assert table_diff([near], [line], last_digits=1) == []
    assert table_diff([line.replace("1.23", "1.25")], [line], last_digits=1) != []
    assert table_diff([line.replace("2.50e+07", "2.51e+07")], [line], last_digits=1) != []
    assert table_diff(["| 0.1 | 3/12 |"], ["| 0.1 | 4/12 |"], last_digits=1) != []
    assert table_diff(["a"], ["a", "b"]) == ["1 lines against 2"]
    assert table_diff(["x 1.2 y"], ["x 1.2 z"], last_digits=1) != []


def test_seed_tuples_are_the_jax_tools():
    assert impair_sweep.SEEDS == jax_tool("impair_sweep").SEEDS
    assert inspect.signature(impair_sweep.read_frac).parameters["seeds"].default == (1, 2, 3)
    assert classifier_sweep.PAD_TO == jax_tool("classifier_sweep").PAD_TO
    assert miller_robustness_sweep.GEOM == jax_tool("miller_robustness_sweep").GEOM
    assert np.array_equal(ranging_sweep.FCC_HOP_FREQS_HZ,
                          jax_tool("ranging_sweep").FCC_HOP_FREQS_HZ)
