"""Compat mode and the exact gate at FM0, 8 and 16 Msps, decim 1 (W 2000
and 4000), on the CPU.

A whole JAX decode there costs 18-88 s, so the gates are held instead:
given the same y, the port's compat ``gate_detect`` and its
``gate_detect_scan`` give the JAX package's event tables, both with |y|
and the average from the port's front end (what the port's compat and
exact decodes read) and with each side forming its own from y (what the
JAX package's exact gate does).  The port's whole decodes read every EPC
of the simulator's truth (tests/geometry_compare.py), and each exact-gate
decode's stats equal the default gate's in its mode.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from gen2_rfid_tpu.dsp import gate as ref_gate
from gen2_rfid_tpu_torch.dsp import filters, gate
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from geometry_compare import DECODES, capture, port_decode, ref_config, want_epcs
from torch_compare import assert_same_events, assert_same_stats, port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

RATES = ["fm0_8msps", "fm0_16msps"]
# Gated commands on a 3-round capture: a Query and an ACK a round.
N_EVENTS = 6

ref_gate_detect = jax.jit(ref_gate.gate_detect, static_argnames=("cfg",))
ref_gate_scan = jax.jit(ref_gate.gate_detect_scan, static_argnames=("cfg",))


def _front(name, label):
    """(cfg, y, amp, avg) of the geometry's capture from the port's front
    end's full build, as the port's compat and exact decodes read them."""
    cfg = port_cfg(ref_config(name, label))
    y2, amp, avgsum, _ = gate_front_for_cfg(inv.to_planar(capture(name).iq), cfg)
    return cfg, torch.complex(y2[0], y2[1]), amp, avgsum / torch.tensor(float(cfg.win_length))


@pytest.mark.parametrize("name", RATES)
def test_compat_gate_equals_jax(name):
    cfg, y, amp, avg = _front(name, "compat")
    ref_cfg = ref_config(name, "compat")
    y_j = jnp.asarray(y.numpy())
    got = gate.gate_detect(y, cfg, amp=amp, avg=avg)
    assert int(got.n_events) == N_EVENTS
    assert_same_events(got, ref_gate_detect(y_j, ref_cfg, jnp.asarray(amp.numpy()),
                                            jnp.asarray(avg.numpy())))
    amp_y = filters.magnitude(y.real, y.imag)
    avg_y = filters.moving_sum(amp_y, cfg.win_length) / torch.tensor(float(cfg.win_length))
    assert_same_events(gate.gate_detect(y, cfg, amp=amp_y, avg=avg_y),
                       ref_gate_detect(y_j, ref_cfg))


@pytest.mark.parametrize("name", RATES)
@pytest.mark.parametrize("label", ["exact_native", "exact_compat"])
def test_exact_gate_equals_jax(name, label):
    """The JAX oracle forms its own |y| and average from y (its exact gate
    never reads a front end's); the port's, given the full build's, gives
    the same table."""
    cfg, y, amp, avg = _front(name, label)
    got = gate.gate_detect_scan(y, cfg, amp, avg)
    assert int(got.n_events) == N_EVENTS
    assert_same_events(got, ref_gate_scan(jnp.asarray(y.numpy()), ref_config(name, label)))


@pytest.mark.parametrize("name", RATES)
def test_decodes_read_the_truth(name):
    stats = {label: port_decode(name, label)[0] for label in DECODES}
    for label, st in stats.items():
        assert int(st.n_epc_correct) == int(st.tag_reads[27]) == want_epcs(name, label)
        assert int(st.n_queries) == capture(name).expected_epc_pass == 3
    assert_same_stats(stats["exact_compat"], stats["compat"])
    default, _ = inv.decode_capture(capture(name).iq, port_cfg(ref_config(name, "exact_native")),
                                    device="cpu")
    assert_same_stats(stats["exact_native"], default)
