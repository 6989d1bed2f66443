"""The port's reports, SNR sweep and debug taps against the JAX package's;
the CW canceller's DC mask at 8 Msps in both; and the port's profiler trace.

* ``tag_signal_report`` and ``tag_report_records`` on the same decoded
  fields (JAX's decode carried into the port with ``carry``) equal JAX's,
  value for value; on each package's own decode, integers and strings are
  equal and floats agree to the records' rounding (a step of their last
  digit: the decodes' channel estimates agree to 1e-4 of their largest
  magnitude, ``torch_compare``).
* ``snr_sweep`` gives JAX's points exactly (the same captures, integer
  EPC counts).
* ``decode_capture_debug``: the JAX function's tap names, dtypes and
  shapes; integer and bool taps equal; y and |y| within 1e-6 of the
  largest |y| (the FIR's summation order and JAX's |y| rounding, ROADMAP
  "Held against the reference"); the moving average and threshold within
  64 float32 ulps of the largest running sum of a (halo + block) row, over
  the window (compat's ``moving_sum``, tests/test_torch_compat.py); the
  gate's DC as y, its noise power to rtol 1e-4 (``torch_compare``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp.interference import cancel_cw_planar as ref_cancel_cw_planar
from gen2_rfid_tpu.runtime import debug as ref_debug
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.runtime import stats as ref_stats
from gen2_rfid_tpu.sim import snr as ref_snr
from gen2_rfid_tpu_torch import carry
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp.interference import cancel_cw_planar
from gen2_rfid_tpu_torch.protocol import tds
from gen2_rfid_tpu_torch.runtime import debug, stats
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.sim import snr
from gen2_rfid_tpu_torch.sim.impairments import RxImpairments, apply_rx_impairments
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.utils import profiling
from torch_compare import assert_same_stats, one_torch_thread  # noqa: F401

ref_decode = jax.jit(ref_inv.decode_capture_planar, static_argnames=("cfg", "exact_gate"))


# ---- the tag reports ---------------------------------------------------------

def _sgtin():
    """tests/test_tds.py's scene: an SGTIN-96 tag, whose records carry a URI."""
    epc = tds.encode_sgtin96("0614141", "812345", 6789, filter_value=3)
    return dict(max_events=64), [Tag(epc96=epc, seed=3)], dict(n_rounds=2, seed=4), None


def _xpc():
    """tests/test_untraceable.py's scene: a U-flagged 2-word tag (XPC word)."""
    tag = Tag.with_id(0x2B, n_words=2, seed=7)
    tag.apply_untraceable(1, None, "none", 0, "normal")
    return dict(max_events=64), [tag], dict(n_rounds=3, seed=5), None


def _pc_length():
    """tests/test_pc_length.py's scene: 2- and 8-word EPCs, a carrier given."""
    tags = [Tag.with_id(0x21, n_words=2, seed=3),
            Tag.with_id(0x88, n_words=8, seed=5, backscatter=0.05 + 0.06j)]
    return dict(epc_bits=161, fixed_q=1, max_events=64), tags, dict(n_rounds=3, seed=15), 915e6


SCENES = {"sgtin": _sgtin, "xpc": _xpc, "pc_length": _pc_length}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    kw, tags, synth, freq_hz = SCENES[request.param]()
    cfg = ReaderConfig(**kw)
    ref_cfg = RefConfig(**kw)
    tr = synthesize_inventory(cfg, tags, **synth)
    ref_st, ref_dec = ref_decode(ref_inv.to_planar(tr.iq), ref_cfg)
    return dict(name=request.param, cfg=cfg, ref_cfg=ref_cfg, tr=tr, freq_hz=freq_hz,
                ref_dec=ref_dec, ref_st=ref_st)


def test_reports_on_the_same_fields_match(scene):
    """JAX's decode carried into the port: the port's reports are JAX's."""
    dec = carry.decoded_from_numpy(scene["ref_dec"])
    assert stats.tag_signal_report(dec) == ref_stats.tag_signal_report(scene["ref_dec"])
    recs = stats.tag_report_records(dec, scene["cfg"], scene["freq_hz"])
    want = ref_stats.tag_report_records(scene["ref_dec"], scene["ref_cfg"], scene["freq_hz"])
    assert recs == want and len(recs) == scene["tr"].expected_epc_pass
    # Each scene shows the field it was chosen for.
    key = {"sgtin": "epc_uri", "xpc": "u_flag", "pc_length": "channel_mhz"}[scene["name"]]
    assert all(key in r for r in recs)
    assert [json.dumps(r) for r in recs] == [json.dumps(r) for r in want]


# Rounding step of each float in a record (tag_report_records' round()).
RECORD_STEP = {"time_s": 1e-6, "rssi_dbfs": 1e-2, "phase_rad": 1e-4}


def test_reports_on_each_decode_match(scene):
    """Each package's own decode: the records are equal key for key, the
    floats to their last rounded digit; the signal report's reads equal."""
    st, dec = inv.decode_capture(scene["tr"].iq, scene["cfg"], device="cpu")
    assert_same_stats(st, scene["ref_st"])
    recs = stats.tag_report_records(dec, scene["cfg"], scene["freq_hz"])
    want = ref_stats.tag_report_records(scene["ref_dec"], scene["ref_cfg"], scene["freq_hz"])
    assert len(recs) == len(want) == scene["tr"].expected_epc_pass
    for r, w in zip(recs, want):
        assert sorted(r) == sorted(w)
        for k in w:
            if k in RECORD_STEP:
                assert abs(r[k] - w[k]) <= RECORD_STEP[k] * 1.0001, (k, r[k], w[k])
            else:
                assert r[k] == w[k], k
    rep, ref = stats.tag_signal_report(dec), ref_stats.tag_signal_report(scene["ref_dec"])
    assert sorted(rep) == sorted(ref)
    for t in ref:
        assert rep[t]["n_reads"] == ref[t]["n_reads"]
        for k in ("rssi_dbfs", "phase_rad", "phase_spread_rad"):
            assert abs(rep[t][k] - ref[t][k]) <= 1e-3, (t, k)


# ---- the SNR sweep -------------------------------------------------------------

def test_snr_sweep_matches_jax():
    """tests/test_snr.py's operating points at n_rounds=4: the same captures,
    the same EPC rates (the waterfall bisections are not run here)."""
    kw = dict(max_events=64)
    got = snr.snr_sweep(ReaderConfig(**kw), [15.0, 3.0], n_rounds=4, device="cpu")
    want = ref_snr.snr_sweep(RefConfig(**kw), [15.0, 3.0], n_rounds=4)
    assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    assert [p.epc_rate for p in got] == [1.0, 0.0]


def test_snr_theory_matches_jax():
    cfg = ReaderConfig(miller_m=4, adc_rate=4e6, decim=2)
    assert snr.sigma_for_snr(cfg, 0.08 + 0.03j, 9.0) == ref_snr.sigma_for_snr(
        RefConfig(miller_m=4, adc_rate=4e6, decim=2), 0.08 + 0.03j, 9.0)
    assert snr.theory_waterfall_db() == ref_snr.theory_waterfall_db()
    for m in (2, 4, 8):
        assert snr.theory_miller_waterfall_db(m) == ref_snr.theory_miller_waterfall_db(m)


# ---- the debug taps --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["native", "compat"])
def test_decode_capture_debug_matches_jax(mode):
    kw = dict(max_events=64, mode=mode)
    tr = synthesize_inventory(ReaderConfig(**kw), [Tag.with_id(27, seed=7)], n_rounds=3, seed=1)
    got = debug.decode_capture_debug(tr.iq, ReaderConfig(**kw), device="cpu")
    want = ref_debug.decode_capture_debug(tr.iq, RefConfig(**kw))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got["stats_n_epc_correct"]) == 3 and got["gate_events"].size > 0
    np.testing.assert_array_equal(got["source"], tr.iq)
    y_scale = np.abs(want["matched_filter"]).max()
    for name in ("matched_filter", "amplitude", "gate_dc"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6 * y_scale,
                                   err_msg=name)
    win = ReaderConfig().win_length
    row_sum = min(tr.iq.size // 5, 8192 + win) * np.abs(want["amplitude"]).max()
    for name in ("moving_avg", "threshold"):
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=2.0 ** -17 * row_sum / win, err_msg=name)
    np.testing.assert_allclose(got["gate_noise_var"], want["gate_noise_var"], rtol=1e-4)


def test_save_taps_round_trip(tmp_path):
    taps = {"amplitude": np.arange(5, dtype=np.float32), "epc_pass": np.array([True, False])}
    debug.save_taps(taps, str(tmp_path / "taps"))
    for name, arr in taps.items():
        back = np.load(tmp_path / "taps" / f"{name}.npy")
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)


def test_decode_capture_debug_needs_a_device():
    """Without a device and without CUDA the twin raises, as every entry
    point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        debug.decode_capture_debug(np.zeros(1000, np.complex64), ReaderConfig())


# ---- the profiler trace -----------------------------------------------------------

def test_trace_writes_a_profile(tmp_path):
    x = torch.arange(1000, dtype=torch.float32)
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        (x * 2).sum()
    assert log_dir == str(tmp_path / "trace")
    assert any(p.stat().st_size for p in (tmp_path / "trace").iterdir())


# ---- plot_signal -------------------------------------------------------------------

def test_plot_signal_writes_png(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from gen2_rfid_tpu_torch.apps import plot_signal
    from gen2_rfid_tpu_torch.io.tracefile import write_trace

    tr = synthesize_inventory(ReaderConfig(max_events=64), [Tag.with_id(27, seed=7)],
                              n_rounds=2, seed=1)
    cap = str(tmp_path / "cap.bin")
    write_trace(cap, tr.iq)
    for extra in ([], ["--events", "--device", "cpu"]):
        out = tmp_path / f"plot{len(extra)}.png"
        assert plot_signal.main([cap, str(out), *extra]) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert capsys.readouterr().out.count("wrote ") == 2


# ---- the CW canceller's DC mask at 8 Msps (ROADMAP §3 item 4) ---------------------------

def test_cw_dc_mask_at_8msps_agrees_with_jax():
    """bench_configs.py::case_miller8_trext's geometry, two tiles of 4 rounds,
    with a -20 dBc tone at 50 kHz.  Both packages mask +-1% of the FFT
    around DC (+-80 kHz at 8 Msps), so neither removes the tone: both
    subtract the same weaker line (124.8 kHz) instead, and both decode
    every EPC with cancel_cw=1, as without it (Miller-8 rejects the tone)."""
    kw = dict(miller_m=8, trext=1, adc_rate=8e6, decim=2, max_events=64)
    tr = synthesize_inventory(ReaderConfig(**kw), [Tag.with_id(27, seed=7)], n_rounds=4, seed=2)
    f = 50e3
    iq = apply_rx_impairments(np.concatenate([tr.iq] * 2),
                              RxImpairments(interferer_dbc=-20.0, interferer_hz=f), 8e6, seed=7)
    x2 = inv.to_planar(iq)
    got = cancel_cw_planar(x2, 1).numpy()
    want = np.asarray(ref_cancel_cw_planar(jnp.asarray(x2.numpy()), 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    rot = np.exp(-2j * np.pi * f / 8e6 * np.arange(iq.size))

    def tone(x2p):
        return abs(np.mean((x2p[0].astype(np.float64) + 1j * x2p[1]) * rot))

    before = tone(x2.numpy())
    assert before > 0.09
    assert tone(got) > 0.999 * before and tone(want) > 0.999 * before
    assert np.abs(got - x2.numpy()).max() > 1e-3           # something else was taken
    st, _ = inv.decode_capture(iq, ReaderConfig(cancel_cw=1, **kw), device="cpu")
    ref_st, _ = ref_decode(ref_inv.to_planar(iq), RefConfig(cancel_cw=1, **kw))
    assert_same_stats(st, ref_st)
    assert int(st.n_epc_correct) == 2 * tr.expected_epc_pass == 8
