"""The port's antenna-diversity decode (dsp/mrc.py, runtime/diversity.py),
its native gate on a given envelope, and ranging from its decodes, against
the JAX package's on the CPU.

Captures are tests/test_diversity.py's and tests/test_ranging.py's: the same
inventory (one tag seed) through two channels with other phases and noise,
and a 4-antenna lambda/4 array at a 25 degree bearing.  Every InventoryStats
field and every DecodedEvents int/bool field must be equal, on valid events
(an invalid event's windows are padding: tests/torch_compare.py); the
per-antenna channel estimates h_chan agree to 1e-4 of their largest
magnitude, angles of arrival to 0.01 degree and PDOA ranges to 1 mm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import gate as ref_gate
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.runtime import ranging as ref_ranging
from gen2_rfid_tpu.runtime.diversity import decode_capture_mrc_full as ref_mrc_full
from gen2_rfid_tpu.sim.tag import Tag
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch import carry
from gen2_rfid_tpu_torch.dsp.filters import run_sum
from gen2_rfid_tpu_torch.dsp.gate import gate_detect
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_for_cfg
from gen2_rfid_tpu_torch.runtime import ranging
from gen2_rfid_tpu_torch.runtime.diversity import (
    decode_capture_mrc, decode_capture_mrc_full, decode_capture_mrc_planar)
from gen2_rfid_tpu_torch.runtime.inventory import decode_capture, to_planar
from torch_compare import assert_same_decoded, assert_same_events, assert_same_stats, port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

BS_A = 0.08 * np.exp(0.4j)
ARRAY_DEG = 25.0


def _two_channel(cfg, n_rounds=4, fade0=False):
    """tests/test_diversity.py::test_mrc_clean_exact's capture pair; with
    ``fade0`` antenna 0 sits in a 60 dB null: its capture scaled by 1e-3
    under noise of the scene's own level, so that its y alone shows no
    command and only the summed envelope gates."""
    iqs = [synthesize_inventory(cfg, [Tag.with_id(27, seed=7, backscatter=bs)],
                                n_rounds=n_rounds, noise=0.004, seed=seed).iq
           for bs, seed in ((BS_A, 100), (0.08 * np.exp(-1.7j), 200))]
    if fade0:
        rng = np.random.default_rng(9)
        noise = rng.normal(0, 0.004 / 2 ** 0.5, (2, iqs[0].size))
        iqs[0] = (iqs[0] * 1e-3 + noise[0] + 1j * noise[1]).astype(np.complex64)
    return iqs


def _array(cfg, theta_deg=ARRAY_DEG, n_rounds=4):
    """tests/test_ranging.py::test_aoa_from_diversity_decode's 4-antenna
    lambda/4 array at one bearing: (antenna positions, captures cut to the
    shortest)."""
    f = cfg.freq_hz
    pos = [k * ref_ranging.C_LIGHT / f / 4 for k in range(4)]
    s = np.sin(np.radians(theta_deg))
    chans = []
    for x in pos:
        phi = 2 * np.pi * f * x * s / ref_ranging.C_LIGHT
        tag = Tag.with_id(27, seed=7, backscatter=0.08 * np.exp(1j * (0.4 + phi)))
        chans.append(synthesize_inventory(cfg, [tag], n_rounds=n_rounds,
                                          seed=int(x * 1e4) + 5).iq)
    n = min(c.size for c in chans)
    return pos, [c[:n] for c in chans]


def _same_mrc(got, want):
    (st, dec, h), (st_r, dec_r, h_r) = got, want
    assert_same_stats(st, st_r)
    assert_same_decoded(dec, dec_r, invalid_rows=False)
    v = dec.valid.numpy() & dec.rn16_fits.numpy() & dec.epc_fits.numpy()
    w = np.asarray(h_r)[v]
    np.testing.assert_allclose(h.numpy()[v], w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.fixture(scope="module")
def mrc_runs():
    """(captures, port run, JAX run) for the two-channel scene in both
    modes, with antenna 0 faded, and for the array."""
    runs = {}
    for label, mode, fade0 in (("native", "native", False), ("compat", "compat", False),
                               ("faded", "native", True)):
        cfg = RefConfig(max_events=64, mode=mode)
        iqs = _two_channel(cfg, fade0=fade0)
        runs[label] = (iqs, decode_capture_mrc_full(iqs, port_cfg(cfg), device="cpu"),
                       ref_mrc_full(iqs, cfg))
    cfg = RefConfig(max_events=64)
    pos, iqs = _array(cfg)
    runs["array"] = (iqs, decode_capture_mrc_full(iqs, port_cfg(cfg), device="cpu"),
                     ref_mrc_full(iqs, cfg), pos)
    return runs


@pytest.mark.parametrize("label", ["native", "compat", "faded", "array"])
def test_mrc_decode_matches_jax(mrc_runs, label):
    _, got, want = mrc_runs[label][:3]
    _same_mrc(got, want)
    st = got[0]
    assert int(st.n_epc_correct) == 4 and int(st.tag_reads[27]) == 4


def test_mrc_planar_and_host_entry_points_agree(mrc_runs):
    iqs, (st, dec, h) = mrc_runs["native"][:2]
    cfg = port_cfg(RefConfig(max_events=64))
    st2, dec2, h2 = decode_capture_mrc_planar(torch.stack([to_planar(x) for x in iqs]), cfg,
                                              device="cpu")
    st3, dec3 = decode_capture_mrc(iqs, cfg, device="cpu")
    for a, b, c in zip(dec, dec2, dec3):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert all(torch.equal(a, b) for a, b in zip(st, st2)) and torch.equal(h, h2)


def test_aoa_from_port_decode_matches_jax(mrc_runs):
    """The array's bearing from the port's decode (CPU tensors into the
    copied runtime/ranging.py) against the JAX package's, and the truth."""
    _, (_, dec, h), (_, dec_r, h_r), pos = mrc_runs["array"]
    cfg = RefConfig(max_events=64)
    got = ranging.aoa_from_mrc(dec, h, pos, cfg.freq_hz)[27]
    want = ref_ranging.aoa_from_mrc(dec_r, h_r, pos, cfg.freq_hz)[27]
    assert abs(got["aoa_deg"] - want["aoa_deg"]) < 0.01
    assert abs(got["aoa_deg"] - ARRAY_DEG) < 1.0 and got["resid_rad"] < 0.1


def test_mrc_decode_is_fm0_only():
    cfg = port_cfg(RefConfig(miller_m=2, adc_rate=2e6, decim=2))
    with pytest.raises(ValueError, match="FM0"):
        decode_capture_mrc_planar(torch.zeros(2, 2, 1000), cfg, device="cpu")


def test_mrc_decode_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_capture_mrc_full([np.ones(100, np.complex64)] * 2, port_cfg(RefConfig()))


# ---- the native gate on the summed envelope ---------------------------------------

ref_gate_detect = jax.jit(ref_gate.gate_detect, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def envelope():
    """Both channels' y2 with antenna 0 faded, and the envelope
    sqrt(|y0|^2 + |y1|^2) with its run_sum average, as the diversity decode
    computes them."""
    cfg = RefConfig(max_events=64)
    y2 = [gate_front_for_cfg(to_planar(x), port_cfg(cfg))[0]
          for x in _two_channel(cfg, fade0=True)]
    p = (y2[0][0] * y2[0][0] + y2[0][1] * y2[0][1]) + (y2[1][0] * y2[1][0] + y2[1][1] * y2[1][1])
    amp = torch.sqrt(p.to(torch.float64)).to(torch.float32)
    avg = run_sum(amp, cfg.win_length) / torch.tensor(float(cfg.win_length))
    return cfg, y2, amp, avg


@pytest.mark.parametrize("with_avg", [True, False], ids=["avg", "no_avg"])
def test_native_gate_on_a_given_envelope_matches_jax(envelope, with_avg):
    """Native gate_detect(y0, amp=, avg=) on the faded antenna's y and the
    summed envelope: the event table equals the JAX package's (without avg
    both take run_sum(amp)/win), and holds the commands that y0's own flags
    lose."""
    cfg, y2, amp, avg = envelope
    pc = port_cfg(cfg)
    y = torch.complex(y2[0][0], y2[0][1])
    got = gate_detect(y, pc, amp=amp, avg=avg if with_avg else None)
    want = ref_gate_detect(jnp.asarray(y.numpy()), cfg, amp=jnp.asarray(amp.numpy()),
                           avg=jnp.asarray(avg.numpy()) if with_avg else None)
    assert_same_events(got, want)
    assert int(got.valid.sum()) == 8
    assert int(gate_detect(y, pc, gate_stack_for_cfg(y2[0], pc)).valid.sum()) == 0


def test_native_gate_on_its_own_magnitude_is_the_kernel_path(envelope):
    """amp = |y| (magnitude's rounding) and no avg: the flags, so the events,
    of the gate-stack path."""
    cfg, y2, _, _ = envelope
    pc = port_cfg(cfg)
    y2 = y2[1]
    y = torch.complex(y2[0], y2[1])
    amp = torch.sqrt((y2[0] * y2[0] + y2[1] * y2[1]).to(torch.float64)).to(torch.float32)
    a = gate_detect(y, pc, amp=amp)
    b = gate_detect(y, pc, gate_stack_for_cfg(y2, pc))
    assert int(a.valid.sum()) == 8
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_native_gate_rejects_avg_without_amp(envelope):
    cfg, y2, _, avg = envelope
    y = torch.complex(y2[0][0], y2[0][1])
    with pytest.raises(ValueError, match="avg only with"):
        gate_detect(y, port_cfg(cfg), avg=avg)


# ---- PDOA ranging from the port's decodes -------------------------------------------

def test_range_from_port_decodes_matches_jax():
    """tests/test_ranging.py::test_ranging_end_to_end_across_hops at three
    hops, each capture cut to the shortest (one JAX compile): the PDOA range
    from the port's decodes (CPU tensors) against the JAX package's."""
    d_true = 3.7
    cfg = RefConfig()
    hops = ref_ranging.FCC_HOP_FREQS_HZ[::24]
    iqs = [synthesize_inventory(RefConfig(freq_hz=f), [Tag.with_id(27, seed=7, distance_m=d_true)],
                                n_rounds=3, seed=int(f) % 1000).iq for f in hops]
    n = min(x.size for x in iqs)
    got, want = [], []
    for f, iq in zip(hops, iqs):
        _, dec = decode_capture(iq[:n], port_cfg(cfg), device="cpu")
        got.append((f, ranging.tag_phase_series(
            carry.decoded_from_numpy(carry.decoded_to_numpy(dec)), cfg)))
        _, dec_r = ref_inv.decode_capture_planar(jnp.asarray(to_planar(iq[:n]).numpy()), cfg)
        want.append((f, ref_ranging.tag_phase_series(dec_r, cfg)))
    est = ranging.range_from_captures(got)[27]
    est_r = ref_ranging.range_from_captures(want)[27]
    assert abs(est["range_m"] - est_r["range_m"]) < 1e-3
    assert abs(est["range_m"] - d_true) < 0.05

