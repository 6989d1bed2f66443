"""The port's wideband path against the JAX package's, on the CPU: the
polyphase channelizer (dsp/channelizer.py), the per-channel decode, and the
flat multi-channel decode and replay (runtime/inventory.py::
decode_events_multi, replay_inventory_batch; runtime/frames.py::
gather_aligned_windows_multi).

The channelizer agrees with the JAX package's to 5e-6 of the largest output
magnitude (both sum the same float32 terms, in another order) and with the
float64 mix-filter-decimate oracle of tests/test_channelizer.py to 2e-5.
Decoded int/bool fields and stats must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import channelizer as ref_chan
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.runtime.frames import gather_aligned_windows_multi as ref_gather_multi
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch import carry
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp import channelizer
from gen2_rfid_tpu_torch.dsp.gate import GateEvents, gate_detect
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime.frames import gather_aligned_windows, gather_aligned_windows_multi
from torch_compare import assert_same_decoded, assert_same_stats, port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

N_CHAN = 8

ref_multi = jax.jit(ref_inv.decode_events_multi, static_argnames=("cfg",))
ref_replay_batch = jax.jit(ref_inv.replay_inventory_batch, static_argnames=("cfg",))


def _oracle_channel(x, h, n_chan, k):
    """Mix-down -> causal lowpass -> decimate-by-N in float64
    (tests/test_channelizer.py:21-27)."""
    n = np.arange(x.size)
    mixed = x.astype(np.complex128) * np.exp(-2j * np.pi * k * n / n_chan)
    return np.convolve(mixed, h.astype(np.float64))[: x.size][::n_chan]


def _rel_err(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def dual_reader():
    """tests/test_channelizer.py's scene: tag 27 on channel 1 (+2 MHz) and tag
    99 on channel 6 (-4 MHz) of one 16 Msps capture, 2 rounds each."""
    synth_cfg = RefConfig(adc_rate=16e6)
    tr_a = synthesize_inventory(synth_cfg, [RefTag.with_id(27, seed=7)], n_rounds=2, seed=3,
                                noise=0.0)
    tr_b = synthesize_inventory(synth_cfg, [RefTag.with_id(99, seed=9)], n_rounds=2, seed=4,
                                noise=0.0)
    n = max(tr_a.iq.size, tr_b.iq.size)

    def place(iq, k):
        pad = np.zeros(n, np.complex64)
        pad[: iq.size] = iq
        return pad * np.exp(2j * np.pi * k * np.arange(n) / N_CHAN).astype(np.complex64)

    rng = np.random.default_rng(5)
    wide = place(tr_a.iq, 1) + place(tr_b.iq, 6)
    wide += (rng.normal(0, 0.002, n) + 1j * rng.normal(0, 0.002, n)).astype(np.complex64)
    return wide, tr_a.expected_epc_pass, tr_b.expected_epc_pass


# ---- the channelizer -------------------------------------------------------

@pytest.mark.parametrize("n_chan,t", [(8, 12), (8, 6), (4, 12), (16, 4)])
def test_pfb_taps_match(n_chan, t):
    np.testing.assert_array_equal(channelizer.pfb_taps(n_chan, t), ref_chan.pfb_taps(n_chan, t))


def test_channel_frequency_matches():
    for k in range(8):
        assert channelizer.channel_frequency(k, 8, 16e6) == ref_chan.channel_frequency(k, 8, 16e6)
    assert channelizer.channel_frequency(6, 8, 16e6) == -4e6


@pytest.mark.parametrize("n_chan,t,n", [(8, 6, 4096), (8, 12, 40000), (4, 12, 4099),
                                        (16, 4, 8192)])
def test_channelize_matches_jax_and_oracle(n_chan, t, n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    got = channelizer.channelize(x, n_chan, t, device="cpu")
    want = ref_chan.channelize(x, n_chan, t)
    assert got.shape == want.shape == (n_chan, n // n_chan) and got.dtype == np.complex64
    assert _rel_err(got, want) <= 5e-6
    h = ref_chan.pfb_taps(n_chan, t)
    for k in range(n_chan):
        ref = _oracle_channel(x, h, n_chan, k)[: got.shape[1]]
        assert _rel_err(got[k], ref) < 2e-5, k


@pytest.mark.parametrize("entry", ["channelize", "decode_wideband"])
def test_wideband_entry_points_turn_tf32_off(monkeypatch, entry):
    """Entry points set the TF32 policy that channelize_planar checks."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = np.zeros(4096, np.complex64)
    if entry == "channelize":
        channelizer.channelize(x, 8, device="cpu")
    else:
        channelizer.decode_wideband(x, 8, ReaderConfig(max_events=8), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32


def test_channelize_planar_layout():
    """(2, N) in, (n_chan, 2, N // n_chan) float32 out, contiguous per
    channel; equal to the host convenience's planes."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=4000) + 1j * rng.normal(size=4000)).astype(np.complex64)
    out = channelizer.channelize_planar(inv.to_planar(x), 8)
    assert out.shape == (8, 2, 500) and out.dtype == torch.float32 and out.is_contiguous()
    host = channelizer.channelize(x, 8, device="cpu")
    np.testing.assert_array_equal(out[:, 0].numpy() + 1j * out[:, 1].numpy(), host)


def test_tone_lands_in_its_channel_only():
    """A tone 100 kHz inside channel 3 passes at about unity there and is
    more than 40 dB down everywhere else (tests/test_channelizer.py)."""
    rate, n, k_tone, off = 16e6, 65536, 3, 100e3
    f = channelizer.channel_frequency(k_tone, N_CHAN, rate) + off
    x = np.exp(2j * np.pi * f * np.arange(n) / rate).astype(np.complex64)
    body = channelizer.channelize(x, N_CHAN, 12, device="cpu")[:, 256:]
    rms = np.sqrt(np.mean(np.abs(body) ** 2, axis=1))
    assert rms[k_tone] > 0.9
    assert np.all(np.delete(rms, k_tone) < 0.01)
    spec = np.fft.fftfreq(body.shape[1], N_CHAN / rate)[np.argmax(np.abs(np.fft.fft(body[k_tone])))]
    assert abs(spec - off) < 2e3


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        channelizer.channelize(np.ones(64, np.complex64), 8)


# ---- per-channel and flat decodes -------------------------------------------

def test_dual_reader_wideband_decode(dual_reader):
    """Each occupied channel reads its own tag every round; the others read
    nothing; every channel's stats equal the JAX package's decode_wideband."""
    wide, exp_a, exp_b = dual_reader
    cfg = ReaderConfig()
    results = channelizer.decode_wideband(wide, N_CHAN, cfg, device="cpu")
    assert len(results) == N_CHAN
    assert int(results[1][0].n_epc_correct) == exp_a == int(results[1][0].tag_reads[27])
    assert int(results[6][0].n_epc_correct) == exp_b == int(results[6][0].tag_reads[99])
    for k in (0, 2, 3, 4, 5, 7):
        assert int(results[k][0].n_epc_correct) == 0
    want = ref_chan.decode_wideband(wide, N_CHAN, RefConfig())
    for k in range(N_CHAN):
        assert_same_stats(results[k][0], want[k][0])


def _channel_tables(wide, cfg, n_chan=N_CHAN):
    """(y_c (C, n) complex64, events_c with (C, cap) leaves) from the port's
    channelizer, front end and gate."""
    chans = channelizer.channelize_planar(inv.to_planar(wide), n_chan)
    ys, evs = [], []
    for k in range(n_chan):
        y2 = gate_front_for_cfg(chans[k].contiguous(), cfg)[0]
        y = torch.complex(y2[0], y2[1])
        ys.append(y)
        evs.append(gate_detect(y, cfg))
    events_c = GateEvents(*(torch.stack(f) for f in zip(*evs)))
    return torch.stack(ys), events_c


def _channel(tup, k):
    return type(tup)(*(f[k] for f in tup))


@pytest.fixture(scope="module")
def multi_tables(dual_reader):
    cfg = ReaderConfig(max_events=24)
    y_c, events_c = _channel_tables(dual_reader[0], cfg)
    return cfg, y_c, events_c


def test_gather_aligned_windows_multi(multi_tables):
    """Window e is the single-channel gather on channel chans[e], row clamps
    included, and equal to the JAX package's."""
    _, y_c, _ = multi_tables
    n = y_c.shape[1]
    rng = np.random.default_rng(3)
    starts = torch.from_numpy(rng.integers(-20, n + 40, 64).astype(np.int32))
    chans = torch.from_numpy(rng.integers(0, N_CHAN, 64).astype(np.int32))
    got = gather_aligned_windows_multi(y_c, starts, chans, 100)
    for e in range(64):
        one = gather_aligned_windows(y_c[int(chans[e])], starts[e:e + 1], 100)[0]
        assert torch.equal(got[e], one)
    want = ref_gather_multi(jnp.asarray(y_c.numpy()), jnp.asarray(starts.numpy()),
                            jnp.asarray(chans.numpy()), 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _same_as_channels(cfg, y_c, events_c, multi):
    """Int/bool fields equal to each channel's own specialized decode; float
    fields to 1e-6 of their largest magnitude (a batched contraction may
    block its sums by batch size)."""
    for k in range(y_c.shape[0]):
        one = inv.decode_events(y_c[k], _channel(events_c, k), cfg, specialize=True,
                                overflow_fallback=False)
        for f in one._fields:
            a, b = getattr(multi, f)[k], getattr(one, f)
            if a.dtype in (torch.int32, torch.bool):
                assert torch.equal(a, b), (k, f)
            else:
                scale = max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= 1e-6 * scale, (k, f)


def test_decode_events_multi_matches_channels_and_jax(multi_tables):
    """The flat decode equals the per-channel specialized decode on every
    field and the JAX package's decode_events_multi on its int/bool fields."""
    cfg, y_c, events_c = multi_tables
    multi = inv.decode_events_multi(y_c, events_c, cfg)
    assert multi.index.shape == events_c.index.shape
    assert multi.epc_bits.shape == events_c.index.shape + (cfg.epc_data_bits,)
    _same_as_channels(cfg, y_c, events_c, multi)
    ref_events = jax.tree.map(lambda t: jnp.asarray(t.numpy()), events_c)
    want = ref_multi(jnp.asarray(y_c.numpy()), ref_events, RefConfig(max_events=24))
    for k in range(y_c.shape[0]):
        assert_same_decoded(_channel(multi, k), _channel(want, k))
    passed = (multi.valid & multi.epc_pass).sum(dim=1)
    assert int(passed[1]) > 0 and int(passed[6]) > 0


def test_replay_inventory_batch_matches(multi_tables):
    """Per-channel stats stacked on the channel axis: the closed form on
    well-formed tables, the scan when one channel's table is malformed
    (an event left unclassified), equal to per-channel replays and to the
    JAX package's replay_inventory_batch."""
    cfg, y_c, events_c = multi_tables
    ref_cfg = RefConfig(max_events=24)
    multi = inv.decode_events_multi(y_c, events_c, cfg)
    broken = multi._replace(cmd_type=multi.cmd_type.clone())
    broken.cmd_type[6, 2] = inv.CMD_UNKNOWN
    assert not inv._replay_fast_ok(_channel(broken, 6), cfg)
    for dec in (multi, broken):
        got = inv.replay_inventory_batch(dec, cfg)
        assert got.n_queries.shape == (N_CHAN,) and got.tag_reads.shape[0] == N_CHAN
        for k in range(N_CHAN):
            assert_same_stats(_channel(got, k), inv.replay_inventory(_channel(dec, k), cfg))
        ref_dec = ref_inv.DecodedEvents(**{f: jnp.asarray(v) for f, v in
                                           carry.decoded_to_numpy(dec).items()})
        assert_same_stats(got, ref_replay_batch(ref_dec, ref_cfg))


def test_decode_events_multi_miller():
    """The flat decode runs the Miller dispatch too: two Miller-4 channels,
    equal to the per-channel decodes."""
    ref_cfg = RefConfig(miller_m=4, adc_rate=4e6, decim=2, max_events=12)
    cfg = port_cfg(ref_cfg)
    ys, evs = [], []
    for tid, seed in ((27, 1), (99, 2)):
        tr = synthesize_inventory(ref_cfg, [RefTag.with_id(tid, seed=7)], n_rounds=2, seed=seed)
        y2 = gate_front_for_cfg(inv.to_planar(tr.iq[:150000]), cfg)[0]
        y = torch.complex(y2[0], y2[1])
        ys.append(y)
        evs.append(gate_detect(y, cfg))
    y_c = torch.stack(ys)
    events_c = GateEvents(*(torch.stack(f) for f in zip(*evs)))
    multi = inv.decode_events_multi(y_c, events_c, cfg)
    _same_as_channels(cfg, y_c, events_c, multi)
    stats = inv.replay_inventory_batch(multi, cfg)
    assert stats.n_epc_correct.tolist() == [2, 2]
    assert int(stats.tag_reads[0, 27]) == 2 and int(stats.tag_reads[1, 99]) == 2
