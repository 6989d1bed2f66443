"""The port's sharded decode on the CPU: shard/decode_sharded.py,
shard/mesh.py, dsp/channelizer.py::decode_wideband_sharded and
shard/dryrun.py.

Against the JAX package's ``decode_capture_sharded`` on its 8 forced CPU
devices (tests/conftest.py), the port on a mesh of CPU positions: stats
equal in every field, the joined tables' index and valid equal in every
row, their int and bool fields equal on valid rows and their floats within
``torch_compare.FLOAT_TOL``.  Against the port's own single-device decode,
which the other test files hold to JAX: tests/test_sharded.py's
invariances (stats, tag reads and owned trigger indices equal).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import channelizer as ref_chan
from gen2_rfid_tpu.shard import decode_sharded as ref_sharded
from gen2_rfid_tpu.shard.mesh import make_mesh as ref_make_mesh
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.dsp import channelizer
from gen2_rfid_tpu_torch.runtime.inventory import (DecodedEvents, decode_capture,
                                                   replay_inventory_batch)
from gen2_rfid_tpu_torch.runtime.stats import InventoryStats
from gen2_rfid_tpu_torch.shard import decode_sharded
from gen2_rfid_tpu_torch.shard.dryrun import dryrun_multichip
from gen2_rfid_tpu_torch.shard.mesh import CHAN_AXIS, TIME_AXIS, make_mesh
from tests.test_fuzz import _scenario
from tests.test_sharded import GEOMETRIES
from torch_compare import assert_same_decoded, assert_same_stats, port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = RefConfig()


def _pad_to(iq, mult):
    return np.pad(iq, (0, (-len(iq)) % mult))


def _channels(*iqs, mult):
    """Captures zero-padded to one length, a multiple of ``mult``, stacked."""
    n = max(x.size for x in iqs)
    n += (-n) % mult
    out = np.zeros((len(iqs), n), np.complex64)
    for k, x in enumerate(iqs):
        out[k, : x.size] = x
    return out


def _cpu_mesh(n_time, n_chan=1):
    return make_mesh(n_time, n_chan, devices=["cpu"] * (n_time * n_chan))


@pytest.fixture(scope="module")
def trace():
    return synthesize_inventory(CFG, [RefTag.with_id(42, seed=4)], n_rounds=8, seed=21)


@pytest.fixture(scope="module")
def other():
    return synthesize_inventory(CFG, [RefTag.with_id(9, seed=4)], n_rounds=3, seed=8)


# ---- against the JAX package's sharded decode ------------------------------

def _assert_same_sharded(got, want, decoded_channels=None):
    """Stats, and index and valid of every row; the decoded fields of the
    valid rows of ``decoded_channels`` (all when None)."""
    (stats, dec), (ref_stats, ref_dec) = got, want
    assert_same_stats(stats, ref_stats)
    np.testing.assert_array_equal(dec.index.numpy(), np.asarray(ref_dec.index))
    np.testing.assert_array_equal(dec.valid.numpy(), np.asarray(ref_dec.valid))
    v = dec.valid.numpy().copy()
    if decoded_channels is not None:
        v[[c for c in range(v.shape[0]) if c not in decoded_channels]] = False
    assert_same_decoded(DecodedEvents(*(f[torch.from_numpy(v)] for f in dec)),
                        SimpleNamespace(**{f: np.asarray(getattr(ref_dec, f))[v]
                                           for f in ref_dec._fields}))


def _sharded_both(ref_cfg, chans, n_time, n_chan=1, eps=256):
    """The port's and the JAX package's sharded decodes of (C, N) ``chans``,
    held equal; returns the port's (stats, tables, decoder gate counts)."""
    mesh = _cpu_mesh(n_time, n_chan)
    dec_fn = decode_sharded.make_sharded_decoder(port_cfg(ref_cfg), mesh, eps)
    iq2 = np.stack([chans.real, chans.imag], axis=1).astype(np.float32)
    got = dec_fn(torch.from_numpy(iq2), with_gated=True)
    want = ref_sharded.decode_capture_sharded(jnp.asarray(chans), ref_cfg,
                                              ref_make_mesh(n_time, n_chan), eps)
    _assert_same_sharded(got[:2], want)
    assert got[1].index.shape == (chans.shape[0], n_time * eps)
    return got


@pytest.mark.parametrize("n_time", [2, 4])
def test_time_sharded_matches_jax(trace, n_time):
    iq = _pad_to(trace.iq, n_time * CFG.decim)
    stats, _, gated = _sharded_both(CFG, iq[None], n_time)
    assert int(stats.n_epc_correct[0]) == trace.expected_epc_pass
    assert gated.shape == (n_time, 1) and int(gated.sum()) >= 16


def test_channel_mesh_matches_jax(trace, other):
    """2 time x 2 chan, each channel its own inventory."""
    stats, _, _ = _sharded_both(CFG, _channels(trace.iq, other.iq, mult=2 * CFG.decim), 2, 2)
    assert stats.n_epc_correct.tolist() == [trace.expected_epc_pass, other.expected_epc_pass]


def test_compat_matches_jax(trace):
    ref_cfg = RefConfig(mode="compat")
    stats, _, _ = _sharded_both(ref_cfg, _pad_to(trace.iq, 2 * CFG.decim)[None], 2)
    assert int(stats.n_epc_correct[0]) == trace.expected_epc_pass


def test_link_geometry_matches_jax():
    """Tari 6.25 us at 640 kHz, decim 1, over 8 time shards."""
    ref_cfg = GEOMETRIES["tari625"]()
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(42, seed=4)], n_rounds=4, seed=21)
    stats, _, _ = _sharded_both(ref_cfg, _pad_to(tr.iq, 8 * ref_cfg.decim)[None], 8)
    assert int(stats.n_epc_correct[0]) == tr.expected_epc_pass


@pytest.mark.parametrize("n_block,halo", [(100, (30, 20)), (100, (100, 100)), (40, (40, 40))])
def test_extended_block_is_the_neighbours_edges(n_block, halo):
    """``extended_block`` (the rule both the in-memory decode and the file
    decode cut blocks by) is each block between its left neighbour's last
    hl_x samples and its right neighbour's first hr_x, zeros where there is
    no neighbour; ``block_span`` puts zeros past n_used even where the
    capture holds more."""
    n_time, (hl_x, hr_x) = 4, halo
    x = torch.arange(2 * n_time * n_block, dtype=torch.float32).reshape(2, -1) + 1
    blocks = [x[:, t * n_block:(t + 1) * n_block] for t in range(n_time)]
    for t in range(n_time):
        left = blocks[t - 1][:, n_block - hl_x:] if t else torch.zeros(2, hl_x)
        right = blocks[t + 1][:, :hr_x] if t < n_time - 1 else torch.zeros(2, hr_x)
        want = torch.cat([left, blocks[t], right], 1)
        assert torch.equal(decode_sharded.extended_block(x, t, n_block, halo), want)
        assert torch.equal(decode_sharded.extended_block(x[None], t, n_block, halo)[0], want)
    a, b, pad_l, pad_r = decode_sharded.block_span(n_time - 1, n_block, n_time * n_block - 7,
                                                   halo)
    assert (a, b - a + pad_l + pad_r) == (3 * n_block - hl_x, hl_x + n_block + hr_x)
    assert pad_r == hr_x + 7


def test_decoder_returns_gate_counts_only_when_asked(trace):
    """Two outputs by default, as the JAX package's decoder gives; the gate
    counts as a third with ``with_gated=True``, equal to the gate's own count
    of each block."""
    cfg = port_cfg(CFG)
    iq = _pad_to(trace.iq, 2 * CFG.decim)
    iq2 = torch.from_numpy(np.stack([iq.real, iq.imag])[None].astype(np.float32))
    dec_fn = decode_sharded.ShardedDecoder(cfg, _cpu_mesh(2), 64)
    stats, dec = dec_fn(iq2)
    stats_g, dec_g, gated = dec_fn(iq2, with_gated=True)
    assert_same_stats(stats_g, stats)
    assert torch.equal(dec_g.index, dec.index)
    n_loc = iq.size // 2
    halo = decode_sharded._halo_x(cfg, n_loc)
    for t in range(2):
        ext = decode_sharded.extended_block(iq2[0], t, n_loc, halo)
        _, events = decode_sharded.gate_block(ext, cfg, decode_sharded._with_cap(cfg, 64))
        assert int(gated[t, 0]) == int(events.n_events)


def test_blocks_shorter_than_their_halo_match_jax(trace):
    """8 blocks of 5,000 samples, under the right halo's 7,240: each halo is
    at most the neighbour's whole block, as the JAX package slices it."""
    assert decode_sharded._halo_x(port_cfg(CFG), 5000) == (4099, 5000)
    _sharded_both(CFG, trace.iq[None, :40000], 8)


def test_shard_overflow_drops_what_jax_drops(trace):
    """A table of 5 rows a shard: the shards gate more triggers than that,
    halo included, and drop the same ones JAX drops (block-first
    compaction before the ownership mask)."""
    stats, _, gated = _sharded_both(CFG, _pad_to(trace.iq, 2 * CFG.decim)[None], 2, eps=5)
    assert (gated > 5).all()
    assert int(stats.n_epc_correct[0]) < trace.expected_epc_pass


def test_capture_end_fit_matches_jax_sharded():
    """A capture cut inside its last EPC window.  The sharded decode checks
    window fit against the block and its zero halo, which runs past the
    capture's end, so it processes that ACK where the single decode does
    not (ROADMAP.md, faults of the reference): the port agrees with the JAX
    package's sharded decode, and both differ from the single decode by
    that one ACK and the round it closes."""
    ref_cfg = RefConfig(max_events=256)
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(42, seed=4)], n_rounds=4, seed=21)
    cut = (12164 + ref_cfg.epc_window // 2) * ref_cfg.decim   # the last ACK at y 12164
    iq = tr.iq[: cut - cut % (2 * ref_cfg.decim)]
    stats, _, _ = _sharded_both(ref_cfg, iq[None], 2)
    single, dec1 = decode_capture(iq, port_cfg(ref_cfg), device="cpu")
    assert int(dec1.index[dec1.valid][-1]) == 12164 and not bool(dec1.epc_fits[dec1.valid][-1])
    assert int(stats.n_epc_correct[0]) == int(single.n_epc_correct)
    assert int(stats.cur_inventory_round[0]) == int(single.cur_inventory_round) + 1
    assert int(stats.n_rounds_closed[0]) == int(single.n_rounds_closed) + 1
    assert int(stats.cmd_counts[0, 2]) == int(single.cmd_counts[2]) + 1


@pytest.mark.parametrize("mode", ["native", "compat"])
def test_command_straddling_a_shard_boundary(trace, mode):
    """The boundary of 2 time shards inside the last PIE low pulse of a
    command near the capture's middle: the second shard sees the command's
    end, the first its start, and the command's trigger is the second's.
    The second shard's gate rebuilds its state from the left halo, whose
    window sums start from zero history at the halo's first sample (as
    ``front_valid`` restarts them): equal to JAX, and to the single decode."""
    ref_cfg = RefConfig(mode=mode, max_events=256)
    cfg = port_cfg(ref_cfg)
    _, dec1 = decode_capture(trace.iq, cfg, device="cpu")
    idx = dec1.index[dec1.valid].numpy()
    k = int(np.argmin(np.abs(idx - trace.iq.size // ref_cfg.decim // 2)))
    b_y = int(idx[k]) - ref_cfg.n_samples_t1 - 1 - ref_cfg.n_samples_pw // 2
    iq = _pad_to(trace.iq, 2 * b_y * ref_cfg.decim)[: 2 * b_y * ref_cfg.decim]
    stats, dec, _ = _sharded_both(ref_cfg, iq[None], 2)
    assert int(dec.index[0, 256:][dec.valid[0, 256:]][0]) == int(idx[k])
    _assert_same_as_single(ref_cfg, iq, 2, sharded=(stats, dec))


def _pfb_scene(n_pfb=4):
    """The dry run's wideband scene (__graft_entry__.py:86-103): tag 27 on
    channel 1 and tag 99 on channel 3 of a 4-channel filterbank."""
    synth_cfg = RefConfig(adc_rate=CFG.adc_rate * n_pfb)
    tr_a = synthesize_inventory(synth_cfg, [RefTag.with_id(27, seed=7)], n_rounds=2, seed=3,
                                noise=0.0)
    tr_b = synthesize_inventory(synth_cfg, [RefTag.with_id(99, seed=9)], n_rounds=2, seed=4,
                                noise=0.0)
    n1 = max(tr_a.iq.size, tr_b.iq.size)

    def place(x, k):
        pad = np.zeros(n1, np.complex64)
        pad[: x.size] = x
        return pad * np.exp(2j * np.pi * k * np.arange(n1) / n_pfb).astype(np.complex64)

    return place(tr_a.iq, 1) + place(tr_b.iq, 3), tr_a.expected_epc_pass, tr_b.expected_epc_pass


def test_decode_wideband_sharded_matches_jax():
    """Stats and every row's index and valid on all four channels; decoded
    fields on the two occupied ones.  The noiseless scene leaves channel 2
    the filterbank's leakage of the readers' commands alone, where the gate
    (relative to its own average) finds one command whose reply window
    holds only leakage: its bits and margin (|h|^2 near 0) follow the two
    channelizers' last-bit differences (tests/test_torch_wideband.py: 5e-6
    of the largest output), and the replay never reads them."""
    wide, n_a, n_b = _pfb_scene()
    ref_cfg = RefConfig(max_events=32)
    got = channelizer.decode_wideband_sharded(wide, 4, port_cfg(ref_cfg), _cpu_mesh(2, 2),
                                              events_per_shard=16)
    want = ref_chan.decode_wideband_sharded(wide, 4, ref_cfg, ref_make_mesh(2, 2),
                                            events_per_shard=16)
    _assert_same_sharded(got, want, decoded_channels=(1, 3))
    assert got[0].n_epc_correct.tolist() == [0, n_a, 0, n_b]


# ---- against the port's own single-device decode ---------------------------

def _assert_same_as_single(ref_cfg, iq, n_time, channel=0, sharded=None, eps=256):
    """The sharded decode of ``iq`` (or channel ``channel`` of a given one)
    equals the single decode: stats in every field, owned trigger indices."""
    cfg = port_cfg(ref_cfg)
    if sharded is None:
        sharded = decode_sharded.decode_capture_sharded(iq[None], cfg, _cpu_mesh(n_time), eps)
    stats, dec = sharded
    single, dec1 = decode_capture(iq, cfg, device="cpu")
    for f in single._fields:
        np.testing.assert_array_equal(getattr(stats, f)[channel].numpy(),
                                      getattr(single, f).numpy(), err_msg=f)
    idx = np.sort(dec.index[channel][dec.valid[channel]].numpy())
    np.testing.assert_array_equal(idx, np.sort(dec1.index[dec1.valid].numpy()))
    return single


def test_shard_count_invariance(trace):
    ref_cfg = RefConfig(max_events=256)
    for n_time in (2, 8):
        st = _assert_same_as_single(ref_cfg, _pad_to(trace.iq, 8 * CFG.decim), n_time)
        assert int(st.n_epc_correct) == trace.expected_epc_pass


@pytest.mark.parametrize("n_time,n_chan,n_ch", [(4, 2, 8), (1, 8, 16)])
def test_many_channels(trace, other, n_time, n_chan, n_ch):
    """4 x 2 and 1 x 8 meshes (test_sharded.py:111-143): each channel its
    own inventory, alternating two captures."""
    ref_cfg = RefConfig(max_events=256)
    chans = _channels(trace.iq, other.iq, mult=n_time * CFG.decim)
    both = np.concatenate([chans] * (n_ch // 2))
    sharded = decode_sharded.decode_capture_sharded(both, port_cfg(ref_cfg),
                                                    _cpu_mesh(n_time, n_chan))
    for c in range(n_ch):
        _assert_same_as_single(ref_cfg, chans[c % 2], n_time, channel=c, sharded=sharded)
    want = [trace.expected_epc_pass, other.expected_epc_pass] * (n_ch // 2)
    assert sharded[0].n_epc_correct.tolist() == want


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("n_time", [2, 8])
def test_link_geometries_equal_single(name, n_time):
    """At max_events=64, 64 rows a shard (the decode's cost grows with the
    rows it holds, valid or not)."""
    ref_cfg = GEOMETRIES[name]()
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(42, seed=4)], n_rounds=4, seed=21)
    st = _assert_same_as_single(ref_cfg, _pad_to(tr.iq, n_time * ref_cfg.decim), n_time,
                                eps=64)
    assert int(st.n_epc_correct) == tr.expected_epc_pass


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_scenarios_equal_single(seed):
    ref_cfg, tags, rng = _scenario(100 + seed)
    n_time = int(rng.choice([2, 4, 8]))
    tr = synthesize_inventory(ref_cfg, tags, n_rounds=3, seed=int(rng.integers(1 << 16)))
    _assert_same_as_single(ref_cfg, _pad_to(tr.iq, n_time * ref_cfg.decim), n_time, eps=64)


def test_sorted_tables_are_stable_and_capped(trace):
    """Owned rows sort by index, every unowned row after them; the cut keeps
    max_events rows of each channel; one channel's table sorts and replays
    alone as in the batch."""
    cfg = port_cfg(dataclasses.replace(CFG, max_events=100))
    _, dec = decode_sharded.decode_capture_sharded(
        _pad_to(trace.iq, 4 * CFG.decim)[None], cfg, _cpu_mesh(4), events_per_shard=64)
    flat = decode_sharded._sort_events(dec, cfg)
    assert flat.index.shape == (1, 100)
    n_own = int(dec.valid.sum())
    assert flat.valid[0, :n_own].all() and not flat.valid[0, n_own:].any()
    assert torch.equal(flat.index[0, :n_own], torch.sort(dec.index[0][dec.valid[0]]).values)
    assert (flat.index[0, n_own:] == decode_sharded.UNOWNED).all()
    one = DecodedEvents(*(f[0] for f in dec))
    assert all(torch.equal(a, b[0]) for a, b in zip(decode_sharded._sort_events(one, cfg), flat))
    assert_same_stats(decode_sharded._sort_and_replay(one, cfg),
                      InventoryStats(*(f[0] for f in replay_inventory_batch(flat, cfg))))


# ---- the mesh and the dry run ----------------------------------------------

def test_make_mesh():
    mesh = make_mesh(n_chan=2, devices=["cpu"] * 8)
    assert mesh.shape == {TIME_AXIS: 4, CHAN_AXIS: 2} and mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(3, 3, devices=["cpu"] * 8)


def test_make_mesh_without_devices_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)


def test_dryrun_multichip(capsys):
    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "mesh=(2 time x 2 chan)" in out and "per-channel EPCs [0, 2, 0, 2]" in out
