"""The port's filters and native gate against the JAX package's.

Integer outputs of the gate (event index, valid, count, pulses) must be
equal; DC and CW noise power agree within float32 summation-order noise
(tests/torch_compare.py::assert_same_events).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import gate as ref_gate
from gen2_rfid_tpu.dsp.filters import matched_filter_decimate as ref_mfd, run_sum as ref_run_sum
from gen2_rfid_tpu.runtime.inventory import matched_taps as ref_matched_taps
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import golden_trace, synthesize_inventory
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp import gate
from gen2_rfid_tpu_torch.dsp.filters import (
    boxcar_taps,
    magnitude,
    matched_filter_decimate,
    run_sum,
)
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime.inventory import matched_taps
from torch_compare import assert_same_events

ref_gate_detect = jax.jit(ref_gate.gate_detect, static_argnames=("cfg",))


def _front(iq, cfg):
    x2 = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(np.float32))
    y2 = gate_front_for_cfg(x2, cfg)[0]
    return torch.complex(y2[0], y2[1])


@pytest.fixture(scope="module")
def golden():
    cfg = ReaderConfig()
    tr = golden_trace(RefConfig())
    return cfg, tr, _front(tr.iq, cfg)


# ---- filters ------------------------------------------------------------

@pytest.mark.parametrize("win", [1, 3, 64, 97, 100, 255])
def test_run_sum_matches_reference_exactly(win):
    rng = np.random.default_rng(win)
    x = (rng.random(20000) * 50).astype(np.float32)
    np.testing.assert_array_equal(run_sum(torch.from_numpy(x), win).numpy(),
                                  np.asarray(ref_run_sum(jnp.asarray(x), win)))
    b = rng.random(20000) > 0.3
    np.testing.assert_array_equal(run_sum(torch.from_numpy(b), win).numpy(),
                                  np.asarray(ref_run_sum(jnp.asarray(b), win)))


@pytest.mark.parametrize("n,decim", [(40961, 5), (9999, 5), (12345, 10)])
def test_matched_filter_decimate_matches_reference(n, decim):
    """GNU Radio zero history and N // decim outputs; taps summed in order
    here, XLA's conv sums in its own order (atol as tests/test_kernels.py)."""
    rng = np.random.default_rng(n)
    iq = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    taps = boxcar_taps(25)
    got = matched_filter_decimate(torch.from_numpy(iq), taps, decim).numpy()
    want = np.asarray(ref_mfd(jnp.asarray(iq), taps, decim))
    assert got.shape == want.shape == (n // decim,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_matched_taps_match():
    for kw in (dict(), dict(blf_hz=80e3), dict(miller_m=4)):
        np.testing.assert_array_equal(matched_taps(ReaderConfig(**kw)),
                                      ref_matched_taps(RefConfig(**kw)))


def test_magnitude_is_correctly_rounded():
    rng = np.random.default_rng(0)
    re, im = rng.normal(size=(2, 100000)).astype(np.float32)
    got = magnitude(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    s = re * re + im * im
    np.testing.assert_array_equal(got, np.sqrt(s.astype(np.float64)).astype(np.float32))


# ---- gate ---------------------------------------------------------------

def test_rises_since_reset_matches_reference():
    rng = np.random.default_rng(3)
    rise = rng.random(30000) < 0.2
    reset = rng.random(30000) < 0.01
    for span in (1, 7, 128, 1280):
        got = gate._rises_since_reset(torch.from_numpy(rise), torch.from_numpy(reset), span)
        want = ref_gate._rises_since_reset(jnp.asarray(rise), jnp.asarray(reset), span)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_gate_detect_matches_reference_on_port_y(golden):
    """Same y in both: the port's flags + gate against gate_detect's native
    mode (which takes |y| from jnp.abs)."""
    cfg, _, y = golden
    got = gate.gate_detect(y, cfg)
    want = ref_gate_detect(jnp.asarray(y.numpy()), RefConfig())
    assert int(got.n_events) == 142
    assert_same_events(got, want)


def test_gate_detect_matches_reference_default_path(golden):
    """The JAX default path filters with XLA's conv: y differs in the last
    bits, the event table does not."""
    cfg, tr, y = golden
    y_ref = ref_mfd(jnp.asarray(tr.iq), ref_matched_taps(RefConfig()), 5)
    want = ref_gate_detect(y_ref, RefConfig())
    assert_same_events(gate.gate_detect(y, cfg), want)


@pytest.mark.parametrize("max_events,n_rounds", [(16, 12), (64, 6)])
def test_gate_detect_capacity_and_drop(max_events, n_rounds):
    """More triggers than capacity: the table keeps the first max_events in
    order and n_events counts them all, as the reference does."""
    cfg = ReaderConfig(max_events=max_events)
    tr = synthesize_inventory(RefConfig(max_events=max_events),
                              [RefTag.with_id(27, seed=7)], n_rounds=n_rounds, seed=4)
    y = _front(tr.iq, cfg)
    got = gate.gate_detect(y, cfg)
    want = ref_gate_detect(jnp.asarray(y.numpy()), RefConfig(max_events=max_events))
    assert int(got.n_events) == 2 * n_rounds
    assert_same_events(got, want)


def test_gate_detect_empty_captures():
    cfg = ReaderConfig(max_events=16)
    rng = np.random.default_rng(9)
    for iq in (np.full(40000, 1.0, np.complex64), np.zeros(40000, np.complex64),
               (rng.normal(0, 0.02, 40000) + 1j * rng.normal(0, 0.02, 40000))
               .astype(np.complex64)):
        ev = gate.gate_detect(_front(iq, cfg), cfg)
        assert int(ev.n_events) == 0 and not bool(ev.valid.any())
        assert bool((ev.index == 8000).all())
