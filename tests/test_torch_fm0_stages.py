"""The optional FM0 stages against the JAX package: CRC-guided recovery
(``epc_softfix``), channel tracking (``track_channel``) and CW cancellation
(``cancel_cw``).

Bits, CRC verdicts and stats must be equal.  Tracked-slicer reliabilities
agree to 1e-4 of their largest magnitude (the running channel estimate is
updated in another float32 order).  A cleaned capture agrees to 1e-5 of
the capture's largest magnitude: both sides form each tone's phase as the
same float32 product, and differ only in the FFT's, the projection sums'
and cos/sin's last bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import fm0 as ref_fm0
from gen2_rfid_tpu.dsp.interference import cancel_cw_planar as ref_cancel_cw_planar
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.runtime import softfix as ref_softfix
from gen2_rfid_tpu.sim.impairments import RxImpairments, apply_rx_impairments
from gen2_rfid_tpu.sim.snr import sigma_for_snr
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import golden_trace, synthesize_inventory
from gen2_rfid_tpu_torch.dsp import fm0, sync
from gen2_rfid_tpu_torch.dsp.interference import cancel_cw, cancel_cw_planar
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime import softfix
from gen2_rfid_tpu_torch.runtime.frames import extract_windows
from torch_compare import assert_same_decoded, assert_same_stats, port_cfg

ref_decode = jax.jit(ref_inv.decode_capture_planar, static_argnames=("cfg", "exact_gate"))
ref_track = jax.jit(jax.vmap(ref_fm0._track_and_slice))

SOFT = RefConfig(epc_softfix=8)


def _decode_both(ref_cfg, iq):
    cfg = port_cfg(ref_cfg)
    stats, dec = inv.decode_capture(iq, cfg, device="cpu")
    ref_stats, ref_dec = ref_decode(ref_inv.to_planar(iq), ref_cfg)
    assert_same_stats(stats, ref_stats)
    assert_same_decoded(dec, ref_dec)
    return stats, dec


def _golden_tuple(stats):
    return (int(stats.n_queries), int(stats.cur_inventory_round),
            int(stats.n_epc_correct), int(stats.tag_reads[0x1B]))


@pytest.fixture(scope="module")
def golden_iq():
    return golden_trace(RefConfig()).iq


# ---- softfix ---------------------------------------------------------------

def _frame_bits():
    return RefTag.with_id(27, seed=3).epc_frame_bits().astype(np.int32)


def _fm0_sign_flip(bits, j):
    out = bits.copy()
    out[j] ^= 1
    if j + 1 < out.size:
        out[j + 1] ^= 1
    return out


def _rel(n, low_at, lo=0.05, hi=1.0):
    r = np.full(n, hi, np.float32)
    r[list(low_at)] = lo
    return r


def _recover_both(ref_cfg, bits, rel):
    cfg = port_cfg(ref_cfg)
    got_bits, got_fixed = softfix.recover_epc_batch(
        torch.from_numpy(bits), torch.from_numpy(rel), cfg,
        lambda b: inv._validate_epc(b, cfg))
    want_bits, want_fixed = ref_softfix.recover_epc_batch(
        jnp.asarray(bits), jnp.asarray(rel), ref_cfg,
        lambda b: ref_inv._validate_epc(b, ref_cfg))
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(got_fixed.numpy(), np.asarray(want_fixed))
    return got_bits.numpy(), got_fixed.numpy()


@pytest.mark.parametrize("flips", [[40], [127], [40, 90], [40, 41]])
def test_fm0_sign_flip_recovery_exact(flips):
    """tests/test_softfix.py's FM0 cases: singles, the last sign, a distant
    pair and adjacent signs, repaired exactly as the JAX package repairs."""
    truth = _frame_bits()
    corrupted = truth
    for j in flips:
        corrupted = _fm0_sign_flip(corrupted, j)
    got, fixed = _recover_both(SOFT, corrupted[None], _rel(truth.size, flips)[None])
    assert fixed[0] and np.array_equal(got[0], truth)


def test_ml_pick_prefers_low_cost_pattern():
    truth = _frame_bits()
    rel = _rel(truth.size, [60], lo=0.02)
    rel[[5, 33, 77, 101, 120]] = 0.2
    got, fixed = _recover_both(SOFT, _fm0_sign_flip(truth, 60)[None], rel[None])
    assert fixed[0] and np.array_equal(got[0], truth)


def test_no_false_accept_on_garbage():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=(400, 128)).astype(np.int32)
    rel = rng.uniform(0.1, 1.0, size=(400, 128)).astype(np.float32)
    _, fixed = _recover_both(SOFT, bits, rel)
    assert int(fixed.sum()) <= 3


def test_candidate_order_on_ties():
    """Equal reliabilities: the lower index ranks first, as lax.top_k ranks."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, size=(64, 128)).astype(np.int32)
    rel = rng.integers(0, 4, size=(64, 128)).astype(np.float32)
    got, cost = softfix.candidate_flips(torch.from_numpy(bits), torch.from_numpy(rel), 8, True)
    want, want_cost = ref_softfix.candidate_flips(jnp.asarray(bits), jnp.asarray(rel), 8, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(want_cost))


def test_softfix_golden_tuple_unchanged(golden_iq):
    stats, _ = _decode_both(SOFT, golden_iq)
    assert _golden_tuple(stats) == (71, 72, 70, 70)


def test_softfix_recovers_at_low_snr():
    """tests/test_softfix.py's 8 dB scene: recovery changes the decode, and
    the port's recovered reads equal the JAX package's."""
    backscatter = 0.08 + 0.03j
    sigma = sigma_for_snr(RefConfig(max_events=64), backscatter, 8.0)
    tag = RefTag.with_id(27, seed=7, backscatter=backscatter)
    tr = synthesize_inventory(RefConfig(max_events=64), [tag], n_rounds=8,
                              noise=sigma, seed=5005)
    plain, _ = _decode_both(RefConfig(max_events=64), tr.iq)
    soft, _ = _decode_both(RefConfig(max_events=64, epc_softfix=8), tr.iq)
    assert int(soft.n_epc_correct) > int(plain.n_epc_correct)
    assert list(np.nonzero(soft.tag_reads.numpy())[0]) == [27]


# ---- channel tracking ------------------------------------------------------

@pytest.mark.parametrize("cfo", [200.0, 800.0])
def test_channel_tracking_cfo_scene(cfo):
    """tests/test_impairments.py's CFO scene: with tracking every EPC decodes
    and the decoded bits equal the JAX package's; untracked, none does."""
    ref_cfg = RefConfig(max_events=64, track_channel=True)
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(27, seed=7, cfo_hz=cfo)],
                              n_rounds=4, seed=13)
    stats, _ = _decode_both(ref_cfg, tr.iq)
    assert int(stats.n_epc_correct) == 4
    off, _ = _decode_both(RefConfig(max_events=64), tr.iq)
    assert int(off.n_epc_correct) == 0


def test_channel_tracking_golden_and_combined(golden_iq):
    stats, _ = _decode_both(RefConfig(track_channel=True), golden_iq)
    assert _golden_tuple(stats) == (71, 72, 70, 70)
    ref_cfg = RefConfig(max_events=64, track_channel=True)
    tag = RefTag.with_id(27, seed=7, blf_offset=0.007, cfo_hz=300.0, amp_ramp=0.15)
    tr = synthesize_inventory(ref_cfg, [tag], n_rounds=6, seed=13)
    stats, _ = _decode_both(ref_cfg, tr.iq)
    assert int(stats.n_epc_correct) == 6


@pytest.mark.parametrize("n", [128, 16, 161])
def test_track_and_slice_matches_reference(n):
    """Random differential samples around a rotating channel, including a
    length that is no multiple of the segment."""
    rng = np.random.default_rng(n)
    e = 32
    h = (rng.normal(size=e) + 1j * rng.normal(size=e)).astype(np.complex64)
    rot = np.exp(1j * 0.05 * np.arange(n))
    sym = rng.choice([-2.0, 0.0, 2.0], size=(e, n))
    d = (sym * h[:, None] * rot[None] + 0.2 * (rng.normal(size=(e, n))
                                               + 1j * rng.normal(size=(e, n))))
    d = d.astype(np.complex64)
    signs, rel = fm0._track_and_slice(torch.from_numpy(d), torch.from_numpy(h))
    want_s, want_r = ref_track(jnp.asarray(d), jnp.asarray(h))
    np.testing.assert_array_equal(signs.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_r), rtol=0,
                               atol=1e-4 * float(np.abs(want_r).max()))


def test_payload_detect_matches_reference(golden_iq):
    """The RN16 machinery at other lengths (access-command replies)."""
    ref_cfg = RefConfig()
    cfg = port_cfg(ref_cfg)
    stats, dec = inv.decode_capture(golden_iq, cfg, device="cpu")
    y2 = gate_front_for_cfg(inv.to_planar(golden_iq), cfg)[0]
    y = torch.complex(y2[0], y2[1])
    events = inv.gate_detect(y, cfg)
    frames, _, _, _ = extract_windows(y, events, cfg)
    index, h_est = sync.tag_sync(frames, cfg)
    ref_payload = jax.vmap(ref_fm0.payload_detect, in_axes=(0, 0, 0, None, None))
    for n_bits in (16, 32, 49):
        got = fm0.payload_detect(frames, index, h_est, cfg, n_bits)
        want = ref_payload(jnp.asarray(frames.numpy()), jnp.asarray(index.numpy()),
                           jnp.asarray(h_est.numpy()), ref_cfg, n_bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got16 = fm0.payload_detect(frames, index, h_est, cfg, 16).numpy()
    valid = dec.valid.numpy()
    np.testing.assert_array_equal(got16[valid][0::2], dec.rn16_bits.numpy()[valid][0::2])


def test_single_frame_detectors_match_reference(golden_iq):
    """The public single-frame hard detectors, ``rn16_detect`` and
    ``epc_detect``, on every valid golden window: bits equal to the JAX
    package's and to the batched decode's, T_half to 1e-6."""
    ref_cfg = RefConfig()
    cfg = port_cfg(ref_cfg)
    y2 = gate_front_for_cfg(inv.to_planar(golden_iq), cfg)[0]
    y = torch.complex(y2[0], y2[1])
    events = inv.gate_detect(y, cfg)
    frames, magn2, _, _ = extract_windows(y, events, cfg)
    index, h_est = sync.tag_sync(frames, cfg)
    valid = events.valid
    frames, magn2, index, h_est = frames[valid], magn2[valid], index[valid], h_est[valid]
    want_rn16 = jax.vmap(ref_fm0.rn16_detect, in_axes=(0, 0, 0, None))(
        jnp.asarray(frames.numpy()), jnp.asarray(index.numpy()), jnp.asarray(h_est.numpy()),
        ref_cfg)
    want_epc, want_thalf = jax.vmap(ref_fm0.epc_detect, in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(frames.numpy()), jnp.asarray(magn2.numpy()), jnp.asarray(index.numpy()),
        jnp.asarray(h_est.numpy()), ref_cfg)
    batch_rn16 = fm0.rn16_detect_soft(frames, index, h_est, cfg)[0]
    batch_epc = fm0.epc_detect_soft(frames, magn2, index, h_est, cfg)[0]
    assert frames.shape[0] == 142
    for e in range(frames.shape[0]):
        rn16 = fm0.rn16_detect(frames[e], index[e], h_est[e], cfg)
        epc, t_half = fm0.epc_detect(frames[e], magn2[e], index[e], h_est[e], cfg)
        np.testing.assert_array_equal(rn16.numpy(), np.asarray(want_rn16[e]))
        np.testing.assert_array_equal(rn16.numpy(), batch_rn16[e].numpy())
        np.testing.assert_array_equal(epc.numpy(), np.asarray(want_epc[e]))
        np.testing.assert_array_equal(epc.numpy(), batch_epc[e].numpy())
        assert abs(float(t_half) - float(want_thalf[e])) <= 1e-6


# ---- CW cancellation -------------------------------------------------------

def _tone_scene(cancel):
    ref_cfg = RefConfig(max_events=64, cancel_cw=cancel)
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(27, seed=7)], n_rounds=3, seed=1)
    iq = apply_rx_impairments(tr.iq, RxImpairments(interferer_dbc=-20.0,
                                                   interferer_hz=40e3),
                              ref_cfg.adc_rate, seed=7)
    return ref_cfg, iq


def _cleaned_both(iq, n_tones):
    x2 = inv.to_planar(iq)
    got = cancel_cw_planar(x2, n_tones).numpy()
    want = np.asarray(ref_cancel_cw_planar(jnp.asarray(x2.numpy()), n_tones))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    return got


@pytest.mark.parametrize("cancel", [0, 1])
def test_cancel_fm0_in_channel_tone(cancel):
    """tests/test_interference.py's FM0 scene: a -20 dBc tone 40 kHz off the
    carrier kills FM0; the canceller restores exact decode.  Events equal the
    JAX package's either way."""
    ref_cfg, iq = _tone_scene(cancel)
    if cancel:
        cleaned = _cleaned_both(iq, cancel)
        assert np.abs(cleaned - inv.to_planar(iq).numpy()).max() > 0.05
    stats, _ = _decode_both(ref_cfg, iq)
    assert int(stats.tag_reads[27]) == (3 if cancel else 0)


@pytest.mark.parametrize("n_tones", [1, 2])
def test_cancel_on_golden(golden_iq, n_tones):
    """The golden capture's strongest off-DC lines are the tag's own +-41.4
    kHz pair.  Removing one leaves the tuple; removing both loses every EPC,
    in the JAX package as in the port."""
    _cleaned_both(golden_iq, n_tones)
    stats, _ = _decode_both(RefConfig(cancel_cw=n_tones), golden_iq)
    assert _golden_tuple(stats) == ((71, 72, 70, 70) if n_tones == 1 else (71, 72, 0, 0))


def test_noise_only_capture_is_untouched():
    rng = np.random.default_rng(0)
    iq = (rng.normal(0, 0.01, 1 << 18) + 1j * rng.normal(0, 0.01, 1 << 18)
          ).astype(np.complex64)
    np.testing.assert_array_equal(cancel_cw(iq, device="cpu"), iq)


def test_two_tone_cancellation():
    ref_cfg = RefConfig(max_events=64, cancel_cw=2)
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(27, seed=7)], n_rounds=3, seed=1)
    t = np.arange(len(tr.iq))
    iq = tr.iq + (0.1 * np.exp(2j * np.pi * 40e3 / 2e6 * t + 0.7j)
                  + 0.08 * np.exp(-2j * np.pi * 55e3 / 2e6 * t + 0.2j)).astype(np.complex64)
    _cleaned_both(iq, 2)
    stats, _ = _decode_both(ref_cfg, iq)
    assert int(stats.tag_reads[27]) == 3
