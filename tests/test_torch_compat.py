"""Compat mode and the exact-gate oracle: the port against the JAX package.

* ``moving_sum``: the port's running sums are float64 and round once; XLA's
  float32 cumsum differs from them by up to a few tens of ulps of a row's
  running sum.  Stated tolerance: 64 float32 ulps (2^-17 relative) of the
  largest running sum in any (halo + block) row.
* The compat gate, given the same |y| and average, gives an event table
  equal to the JAX one; from y alone (each side computing its own |y| and
  average) too, on the captures here.
* The compat and exact-gate decodes give the JAX package's stats and
  integer decode fields exactly, with float fields as ``torch_compare``
  states.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import filters as ref_filters
from gen2_rfid_tpu.dsp import gate as ref_gate
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import golden_trace, synthesize_inventory
from gen2_rfid_tpu_torch.dsp import filters, gate
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.kernels.gate_scan import gate_scan_plain, pulse_train
from gen2_rfid_tpu_torch.runtime import inventory as inv
from torch_compare import (
    assert_same_decoded,
    assert_same_events,
    assert_same_stats,
    port_cfg,
)

ref_gate_detect = jax.jit(ref_gate.gate_detect, static_argnames=("cfg",))
ref_gate_scan = jax.jit(ref_gate.gate_detect_scan, static_argnames=("cfg",))
ref_decode = jax.jit(ref_inv.decode_capture_planar, static_argnames=("cfg", "exact_gate"))
ref_decode_block = jax.jit(ref_inv.decode_block, static_argnames=("cfg", "exact_gate"))
ref_moving_sum = jax.jit(ref_filters.moving_sum, static_argnames=("win", "block"))

COMPAT = RefConfig(mode="compat")


def _front(iq, cfg):
    """The port's front end on a capture: (y, amp, avg) as the compat path
    reads them."""
    y2, amp, avgsum, _ = gate_front_for_cfg(inv.to_planar(iq), cfg)
    avg = avgsum / torch.tensor(float(cfg.win_length))
    return torch.complex(y2[0], y2[1]), amp, avg


def _from_y(y, cfg):
    """(amp, avg) from y alone as the JAX gate forms them when given only y:
    |y| and compat's blocked-cumsum moving sum over the window, here in the
    port's definitions (correctly rounded |y|, float64 running sums)."""
    amp = filters.magnitude(y.real, y.imag)
    return amp, filters.moving_sum(amp, cfg.win_length) / torch.tensor(float(cfg.win_length))


@pytest.fixture(scope="module")
def golden():
    tr = golden_trace(COMPAT)
    return (tr,) + _front(tr.iq, port_cfg(COMPAT))


# ---- moving sums ----------------------------------------------------------

@pytest.mark.parametrize("n,block,halo", [(20000, 8192, 100), (8192, 8192, 1),
                                          (5, 8, 8), (1000, 64, 48)])
def test_overlap_blocks_match_reference(n, block, halo):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(
        filters._overlap_blocks(torch.from_numpy(x), block, halo).numpy(),
        np.asarray(ref_filters._overlap_blocks(jnp.asarray(x), block, halo)))


@pytest.mark.parametrize("n,win,block", [(3 * 8192, 100, 8192), (40961, 48, 8192),
                                         (1000, 100, 256), (7, 4, 8192)])
def test_moving_sum_matches_reference(n, win, block):
    x = np.abs(np.random.default_rng(n).normal(1.0, 0.1, n)).astype(np.float32)
    got = filters.moving_sum(torch.from_numpy(x), win, block).numpy()
    want = np.asarray(ref_moving_sum(jnp.asarray(x), win=win, block=block))
    # Exact window sums, rounded once: what the port's definition gives.
    exact = np.convolve(x.astype(np.float64), np.ones(win))[:n].astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    rows = filters._overlap_blocks(torch.from_numpy(x), block, win).numpy()
    tol = 2.0 ** -17 * float(rows.astype(np.float64).sum(axis=1).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_moving_sum_complex_matches_reference():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=9000) + 1j * rng.normal(size=9000)).astype(np.complex64)
    got = filters.moving_sum_complex(torch.from_numpy(x), 48).numpy()
    want = np.asarray(ref_filters.moving_sum_complex(jnp.asarray(x), 48))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ---- the compat gate ------------------------------------------------------

def test_signal_state_keeps_ties():
    """Equality keeps the previous state; the state starts NEG."""
    amp = np.array([1, 1, 3, 2, 2, 0, 2, 5, 2], np.float32)
    th = np.full(9, 2.0, np.float32)
    got = gate.gate_signal_state(torch.from_numpy(amp), torch.from_numpy(th)).numpy()
    want = np.asarray(ref_gate.gate_signal_state(jnp.asarray(amp), jnp.asarray(th)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-1, -1, 1, 1, 1, -1, -1, 1, 1])
    rng = np.random.default_rng(5)
    amp = rng.integers(0, 4, 5000).astype(np.float32)
    th = rng.integers(0, 4, 5000).astype(np.float32)
    np.testing.assert_array_equal(
        gate.gate_signal_state(torch.from_numpy(amp), torch.from_numpy(th)).numpy(),
        np.asarray(ref_gate.gate_signal_state(jnp.asarray(amp), jnp.asarray(th))))


def test_compat_gate_given_amp_avg_matches_reference(golden):
    """The path the compat decode takes: |y| and the average from the front
    end, the same arrays into both gates."""
    _, y, amp, avg = golden
    got = gate.gate_detect(y, port_cfg(COMPAT), amp=amp, avg=avg)
    want = ref_gate_detect(jnp.asarray(y.numpy()), COMPAT, jnp.asarray(amp.numpy()),
                           jnp.asarray(avg.numpy()))
    assert int(got.n_events) == 142
    assert_same_events(got, want)


def test_compat_gate_from_y_matches_reference(golden):
    """From y alone: the port's correctly rounded |y| and float64 moving sum
    against jnp.abs and XLA's cumsum."""
    _, y, _, _ = golden
    cfg = port_cfg(COMPAT)
    amp, avg = _from_y(y, cfg)
    got = gate.gate_detect(y, cfg, amp=amp, avg=avg)
    assert_same_events(got, ref_gate_detect(jnp.asarray(y.numpy()), COMPAT))
    with pytest.raises(ValueError, match="needs amp and avg"):
        gate.gate_detect(y, cfg)


@pytest.mark.parametrize("max_events,n_rounds,q", [(16, 12, 0), (64, 6, 2)])
def test_compat_gate_capacity_and_slots(max_events, n_rounds, q):
    ref_cfg = RefConfig(mode="compat", max_events=max_events, fixed_q=q)
    tags = [RefTag.with_id(i + 1, seed=i, backscatter=0.08 + 0.02j) for i in range(3)]
    tr = synthesize_inventory(ref_cfg, tags, n_rounds=n_rounds, seed=4)
    cfg = port_cfg(ref_cfg)
    y, amp, avg = _front(tr.iq, cfg)
    got = gate.gate_detect(y, cfg, amp=amp, avg=avg)
    want = ref_gate_detect(jnp.asarray(y.numpy()), ref_cfg, jnp.asarray(amp.numpy()),
                           jnp.asarray(avg.numpy()))
    assert int(got.n_events) > 0
    assert_same_events(got, want)


# ---- the exact-gate oracle ------------------------------------------------

@pytest.mark.parametrize("mode", ["compat", "native"])
def test_gate_detect_scan_matches_reference(golden, mode):
    """Same y into both oracles, each side forming its own |y| and average."""
    _, y, _, _ = golden
    ref_cfg = RefConfig(mode=mode)
    cfg = port_cfg(ref_cfg)
    got = gate.gate_detect_scan(y, cfg, *_from_y(y, cfg))
    want = ref_gate_scan(jnp.asarray(y.numpy()), ref_cfg)
    assert int(got.n_events) == 142
    assert_same_events(got, want)


def test_compat_gate_equals_oracle(golden):
    """The block-parallel compat gate and the sequential FSM agree on every
    valid event and its pulse count (tests/test_dsp.py's invariant, exact
    here because both read the same |y| and average)."""
    _, y, amp, avg = golden
    cfg = port_cfg(COMPAT)
    vec = gate.gate_detect(y, cfg, amp=amp, avg=avg)
    scan = gate.gate_detect_scan(y, cfg, amp=amp, avg=avg)
    assert int(vec.n_events) == int(scan.n_events) == 142
    v, s = vec.valid, scan.valid
    assert torch.equal(v, s)
    assert torch.equal(vec.index[v], scan.index[s])
    assert torch.equal(vec.n_pulses[v], scan.n_pulses[s])
    assert torch.equal(vec.dc[v], scan.dc[s])
    n = y.shape[0]
    assert bool((scan.index[~s] == n - 1).all()) and bool((vec.index[~v] == n).all())


def test_gate_scan_plain_fsm_by_hand():
    """Six long pulses then a long high: one trigger nt1+1 samples after the
    last rise, with six pulses; the gate then stays open an RN16 window."""
    pw_half, nt1, npc = 2, 5, 5
    amp = []
    for _ in range(6):
        amp += [0.0] * 4 + [2.0] * 4
    amp += [2.0] * 40
    a = torch.tensor(amp, dtype=torch.float32)
    trig, pulses = gate_scan_plain(a, torch.ones_like(a), 1.0, pw_half, nt1, npc, 30, 50)
    last_rise = 5 * 8 + 4
    assert trig.nonzero().flatten().tolist() == [last_rise + nt1 + 1]
    assert int(pulses[last_rise + nt1 + 1]) == 6
    # A short low run (<= pw_half) resets the count.
    amp[37] = 0.0
    trig, _ = gate_scan_plain(torch.tensor(amp), torch.ones(len(amp)), 1.0,
                              pw_half, nt1, npc, 30, 50)
    assert not bool(trig.any())


@pytest.mark.parametrize("n,rn16w,epcw", [(40961, 1, 1), (40961, 1, 37), (20481, 40, 4100),
                                          (12289, 33, 64), (4097, 5, 3), (4096, 1, 1)])
def test_gate_scan_plain_on_pulse_trains(n, rn16w, epcw):
    """The synthetic trains the card test feeds the kernel: the plain FSM
    triggers exactly at the planned samples, each with npc+1 pulses, and the
    trains put triggers on word and chunk ends and on the last sample."""
    pw_half, nt1, npc = 2, 5, 3
    amp, avg, targets = pulse_train(n, pw_half, nt1, npc, rn16w, epcw, seed=n)
    trig, pulses = gate_scan_plain(amp, avg, 0.5, pw_half, nt1, npc, rn16w, epcw)
    assert trig.nonzero().flatten().tolist() == targets
    assert pulses[targets].tolist() == [npc + 1] * len(targets)
    assert targets[-1] == n - 1
    assert any(t % 32 == 31 for t in targets[:-1])
    assert bool((amp == avg * 0.5).any())      # ties
    if n > 8192:
        assert any(t % 4096 == 4095 for t in targets)
    if max(rn16w, epcw) > 1 and n > 8192:
        wins = [epcw if k % 2 else rn16w for k in range(len(targets))]
        assert any(t // 4096 != (t + w - 1) // 4096 for t, w in zip(targets, wins))


# ---- decodes ----------------------------------------------------------------

def _assert_same_decode(ref_cfg, iq, exact_gate=False):
    cfg = port_cfg(ref_cfg)
    stats, dec = inv.decode_capture(iq, cfg, exact_gate=exact_gate, device="cpu")
    ref_stats, ref_dec = ref_decode(ref_inv.to_planar(iq), ref_cfg, exact_gate)
    assert_same_stats(stats, ref_stats)
    assert_same_decoded(dec, ref_dec)
    return stats, dec


@pytest.mark.parametrize("pallas_front", [False, True])
def test_compat_golden_decode_matches_reference(golden, pallas_front):
    """JAX compat through XLA's conv and cumsum, and through the Pallas front
    end (interpret mode) that the port's path mirrors."""
    tr = golden[0]
    stats, _ = _assert_same_decode(dataclasses.replace(COMPAT, pallas_front=pallas_front),
                                   tr.iq)
    assert (int(stats.n_queries), int(stats.cur_inventory_round),
            int(stats.n_epc_correct), int(stats.tag_reads[0x1B])) == (71, 72, 70, 70)


def test_compat_multitag_q2_decode_matches_reference():
    ref_cfg = RefConfig(mode="compat", fixed_q=2)
    tags = [RefTag.with_id(i + 1, seed=i, backscatter=0.08 + 0.02j) for i in range(3)]
    tr = synthesize_inventory(ref_cfg, tags, n_rounds=6, seed=5)
    stats, _ = _assert_same_decode(ref_cfg, tr.iq)
    assert int(stats.n_epc_correct) == tr.expected_epc_pass


@pytest.mark.parametrize("mode", ["native", "compat"])
def test_exact_gate_end_to_end(golden, mode):
    """exact_gate=True against the JAX package's, and against the port's own
    default gate (tests/test_golden.py::test_exact_gate_agrees_end_to_end)."""
    tr = golden[0]
    ref_cfg = RefConfig(mode=mode)
    stats, _ = _assert_same_decode(ref_cfg, tr.iq, exact_gate=True)
    default, _ = inv.decode_capture(tr.iq, port_cfg(ref_cfg), device="cpu")
    assert_same_stats(stats, default)


def test_exact_gate_decode_block_matches_reference(golden):
    """decode_block(exact_gate=True) on the same y, each side forming its
    own |y| and average."""
    _, y, _, _ = golden
    cfg = port_cfg(COMPAT)
    amp, avg = _from_y(y, cfg)
    stats, dec = inv.decode_block(y, cfg, exact_gate=True, amp=amp, avg=avg)
    ref_stats, ref_dec = ref_decode_block(jnp.asarray(y.numpy()), COMPAT, exact_gate=True)
    assert_same_stats(stats, ref_stats)
    assert_same_decoded(dec, ref_dec)
