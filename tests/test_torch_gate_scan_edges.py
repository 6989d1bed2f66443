"""The gate-scan kernel's edge walk, modelled on the CPU.

``kernels/gate_scan.py::gate_scan_edges_plain`` is a Python model of the
CUDA kernel's phases (the decision masks and the free-running edge list, the
walk over that list 32 edges a step, the fill).  Its outputs must be the
per-sample FSM's (``gate_scan_plain``) on every input, exactly, and its
events the JAX oracle's (``gen2_rfid_tpu/dsp/gate.py::gate_detect_scan``) on
the golden trace.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import gate as ref_gate
from gen2_rfid_tpu.sim.trace import golden_trace
from gen2_rfid_tpu_torch.dsp import filters, gate
from gen2_rfid_tpu_torch.kernels import gate_scan as gs
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from torch_compare import assert_same_events, port_cfg

REF = RefConfig()
CFG = port_cfg(REF)
CFG_ARGS = (CFG.thresh_fraction, CFG.n_samples_pw // 2, CFG.n_samples_t1,
            CFG.num_pulses_command, CFG.rn16_window, CFG.epc_window)


def _same(amp, avg, args):
    """Model == plain on both outputs; returns the model's step count."""
    want_t, want_p = gs.gate_scan_plain(amp, avg, *args)
    got_t, got_p, steps = gs.gate_scan_edges_plain(amp, avg, *args)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_p, want_p)
    return steps, got_t


@pytest.fixture(scope="module")
def golden():
    """The golden capture: y, |y| and its average from the port's front end."""
    tr = golden_trace(REF)
    y2, amp, avgsum, _ = gate_front_for_cfg(inv.to_planar(tr.iq), CFG)
    return torch.complex(y2[0], y2[1]), amp, avgsum / torch.tensor(float(CFG.win_length))


def test_model_matches_plain_on_golden(golden):
    """142 triggers; the walk takes under 10% as many steps as samples."""
    _, amp, avg = golden
    steps, trig = _same(amp, avg, CFG_ARGS)
    assert int(trig.sum()) == 142
    assert steps < 0.1 * amp.numel()


def test_model_events_match_jax_oracle(golden):
    """Same y into both; each side forms its own |y| and average."""
    y, _, _ = golden
    amp = filters.magnitude(y.real, y.imag)
    avg = filters.moving_sum(amp, CFG.win_length) / torch.tensor(float(CFG.win_length))
    trig, pulses, _ = gs.gate_scan_edges_plain(amp, avg, *CFG_ARGS)
    got = gate.events_from_scan(y, trig, pulses, CFG)
    want = jax.jit(ref_gate.gate_detect_scan, static_argnames=("cfg",))(
        jnp.asarray(y.numpy()), REF)
    assert int(got.n_events) == 142
    assert_same_events(got, want)


@pytest.mark.parametrize("n,rn16w,epcw", [(40961, 1, 1), (40961, 1, 37), (20481, 40, 4100),
                                          (12289, 33, 64), (4097, 5, 3), (4096, 1, 1)])
def test_model_on_pulse_trains(n, rn16w, epcw):
    """Triggers exactly at the planned targets, on word and group ends and
    on the last sample; windows of one sample; a window past the end."""
    amp, avg, targets = gs.pulse_train(n, 2, 5, 3, rn16w, epcw, seed=n)
    _, trig = _same(amp, avg, (0.5, 2, 5, 3, rn16w, epcw))
    assert trig.nonzero().flatten().tolist() == targets


@pytest.mark.parametrize("n", [100003, 1025, 33, 1])
@pytest.mark.parametrize("args", [CFG_ARGS, (0.75, 0, 0, 0, 1, 3), (0.75, 0, 1, 1, 3, 2000)])
def test_model_on_dense_edges(n, args):
    """An edge about every other sample, with the configuration's arguments,
    with arguments that trigger often, and with a long EPC window."""
    amp, avg = gs.dense_edges(n, seed=n)
    steps, trig = _same(amp, avg, args)
    # A step per 32 edges, and two per trigger (its batch ends early and the
    # walk resumes after its window).
    assert steps <= n // 32 + 2 * int(trig.sum()) + 1


@pytest.mark.parametrize("n", [5000, 1])
def test_model_on_ties(n):
    """amp equal to its threshold everywhere: no edge, no step."""
    amp = torch.ones(n)
    steps, trig = _same(amp, amp / CFG.thresh_fraction, CFG_ARGS)
    assert steps == 0 and not bool(trig.any())


def test_model_window_past_the_end():
    """A trigger whose window runs past the capture's end, and one on the
    last sample."""
    lo, hi = [0.0] * 4, [2.0] * 4
    amp = torch.tensor(lo + hi + lo + [2.0] * 7, dtype=torch.float32)
    args = (1.0, 2, 5, 1, 100, 100)
    _, trig = _same(amp, torch.ones_like(amp), args)
    assert trig.nonzero().flatten().tolist() == [amp.numel() - 1]
    _, trig = _same(torch.cat([amp, torch.full((20,), 2.0)]), torch.ones(amp.numel() + 20),
                    args)
    assert trig.nonzero().flatten().tolist() == [amp.numel() - 1]


@pytest.mark.parametrize("seed", range(12))
def test_model_on_random_runs(seed):
    """Runs of above, below and tied samples with short windows: triggers
    often, and the walk resumes after windows that end in every state."""
    amp, avg, args = gs.random_runs(seed)
    _, trig = _same(amp, avg, args)
    assert bool(trig.any())


def test_word_edges_match_a_loop():
    """The bit-parallel fill against a walk over each word's 32 samples."""
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32) & ~hi
    hi[:50] = 0
    lo[:50] &= rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    inc = rng.random(500) < 0.5
    edges, state = gs._word_edges(hi, lo, inc)
    for w in range(500):
        s, e, after = bool(inc[w]), 0, 0
        for b in range(32):
            if (int(hi[w]) >> b) & 1 and not s:
                e, s = e | 1 << b, True
            elif (int(lo[w]) >> b) & 1 and s:
                e, s = e | 1 << b, False
            after |= int(s) << b
        assert int(edges[w]) == e and int(state[w]) == after


def test_model_rejects_what_the_walk_cannot_take():
    amp = torch.ones(10)
    for bad in [(0.5, 2, -1, 3, 5, 5), (0.5, 2, 5, -1, 5, 5), (0.5, 2, 5, 3, 0, 5)]:
        with pytest.raises(ValueError, match="gate_scan needs"):
            gs.gate_scan_edges_plain(amp, amp, *bad)
