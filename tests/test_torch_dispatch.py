"""The port's decode dispatch on the CPU: the host tables kept on the device
per (cfg, device), and ``decode_block``'s one read, with the two fallbacks
that read sends a table to (the paranoid decode of a table that overflows
the role tables, the sequential scan of one that fails the closed form's
preconditions), each bit-equal to the parent path's choice.
"""

import math

import numpy as np
import pytest
import torch

from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp import filters, fm0, sync
from gen2_rfid_tpu_torch.dsp.gate import front_end, gate_detect
from gen2_rfid_tpu_torch.protocol.crc import crc16_affine
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime import softfix
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import golden_trace, synthesize_inventory
from gen2_rfid_tpu_torch.utils import profiling
from torch_compare import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
CFG = ReaderConfig()


def _same(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _scene(n_rounds, seed, max_events):
    cfg = ReaderConfig(max_events=max_events)
    tr = synthesize_inventory(cfg, [Tag.with_id(27, seed=7)], n_rounds=n_rounds, seed=seed)
    y, flags, _, _ = front_end(inv.to_planar(tr.iq), cfg)
    return cfg, y, flags


def _counters():
    return dict(inv.replays), dict(inv.redecodes)


def _host_tables(cfg):
    """(what the cache holds, what ``torch.as_tensor`` builds from the NumPy
    tables) for every table a native FM0 decode, a compat CRC, softfix and
    the CW canceller keep on the device."""
    hb_pos, chips, n_off = sync.sync_positions(cfg)
    offs, _ = fm0._half_bit_offsets(cfg, cfg.rn16_half_bits)
    probes, _ = fm0._energy_positions(cfg)
    cand, _ = fm0.epc_period_grid(cfg)
    i1, i2, _ = fm0._bit_position_tables(cfg)
    m_all, c0_all, r_all, id_all, _ = inv._pc_length_tables(cfg.epc_data_bits)
    m, c0 = crc16_affine(96 - 16)
    pi, pj = np.triu_indices(4, 1)
    f32 = torch.float32
    return [
        (inv._pulse_counts_device(cfg, CPU), torch.as_tensor(inv.expected_pulse_counts(cfg))),
        *zip(inv._pc_length_device(cfg.epc_data_bits, CPU)[:4],
             (torch.as_tensor(m_all, dtype=f32), torch.as_tensor(c0_all),
              torch.as_tensor(r_all, dtype=f32), torch.as_tensor(id_all, dtype=f32))),
        (inv._bit_weights(5, CPU), torch.as_tensor(2 ** np.arange(4, -1, -1))),
        (inv._bit_weights(8, CPU), torch.as_tensor(2 ** np.arange(7, -1, -1))),
        *zip(inv._crc_fixed_device(80, CPU),
             (torch.as_tensor(m.T, dtype=f32), torch.as_tensor(c0.astype(np.int32)))),
        *zip(sync._search_device(cfg, CPU),
             (torch.as_tensor(hb_pos)[:, None] + torch.arange(n_off),
              torch.as_tensor(sync._PREAMBLE_PM)[:, None], torch.as_tensor(chips))),
        (fm0._half_bit_offsets_device(cfg, cfg.rn16_half_bits, CPU)[0], torch.as_tensor(offs)),
        *zip(fm0._period_device(cfg, CPU),
             (torch.as_tensor(probes), torch.as_tensor(cand), torch.as_tensor(i1),
              torch.as_tensor(i2))),
        *zip(softfix._pair_indices(4, CPU),
             (torch.as_tensor(pi.astype(np.int64)), torch.as_tensor(pj.astype(np.int64)))),
        (filters.f32_scalar(-2.0 * math.pi, CPU),
         torch.as_tensor(-2.0 * math.pi, dtype=f32)),
    ]


def test_cached_tables_equal_what_as_tensor_builds():
    """Each table on the device has the dtype, shape and values that
    ``torch.as_tensor`` gives the NumPy table, and is built once: a second
    lookup returns the same tensor."""
    first, again = _host_tables(CFG), _host_tables(CFG)
    assert len(first) == 20
    for (got, want), (got2, _) in zip(first, again):
        assert got.dtype == want.dtype and got.device == CPU
        assert torch.equal(got, want)
        assert got2 is got


def test_second_golden_decode_copies_no_table():
    """The first decode on a device copies the host tables; a second decode
    of the golden trace opens no ``gen2.host_copy`` span and one
    ``gen2.host_read``, inside the replay, and reports the golden tuple."""
    x2 = inv.to_planar(golden_trace(CFG).iq)
    inv.decode_capture_planar(x2, CFG, device="cpu")
    with profiling.recording():
        stats, _ = inv.decode_capture_planar(x2, CFG, device="cpu")
    rows = profiling.spans()
    names = {r["index"]: r["name"] for r in rows}
    assert not [r for r in rows if r["name"] == profiling.HOST_COPY]
    reads = [r for r in rows if r["name"] == profiling.HOST_READ]
    assert [names[r["parent"]] for r in reads] == ["gen2.replay"]
    assert (int(stats.n_queries), int(stats.cur_inventory_round),
            int(stats.n_epc_correct)) == (71, 72, 70)


def test_overflowing_table_is_decoded_again_paranoid(monkeypatch):
    """Every event forced to a Query (48 of them) overflows the 43-row role
    tables at ``max_events`` 52: ``decode_block``'s one read sends the table
    to the paranoid decode, whose outputs and replay it returns bit for
    bit, and counts one redecode and one replay."""
    cfg, y, flags = _scene(24, 9, 52)

    def all_queries(*args, **kwargs):
        ev = gate_detect(*args, **kwargs)
        return ev._replace(n_pulses=torch.full_like(ev.n_pulses, 4 + cfg.query_length))

    events = all_queries(y, cfg, flags)
    assert int(events.valid.sum()) == 48
    want_dec = inv.decode_events(y, events, cfg, specialize=False)
    want = inv.replay_inventory(want_dec, cfg)
    monkeypatch.setattr(inv, "gate_detect", all_queries)
    replays, redecodes = _counters()
    stats, dec = inv.decode_block(y, cfg, flags)
    _same(dec, want_dec)
    _same(stats, want)
    assert inv.redecodes == {"paranoid": redecodes["paranoid"] + 1}
    assert sum(inv.replays.values()) == sum(replays.values()) + 1
    assert int(stats.n_queries) == 48


def test_refit_after_an_unfit_event_is_scanned(monkeypatch):
    """An ACK whose EPC window runs past y's end, followed by a Query whose
    RN16 window fits, fails the closed form's preconditions:
    ``decode_block`` returns the specialized decode and its sequential
    scan's stats, and counts one scan."""
    cfg, y, flags = _scene(4, 3, 64)
    n = y.shape[0]

    def with_tail(*args, **kwargs):
        ev = gate_detect(*args, **kwargs)
        j = int(ev.valid.sum())
        at = [int(ev.index[j - 1]) + cfg.epc_window + 50, n - cfg.rn16_window - 50]
        pulses = [3 + 2 + 16, 4 + cfg.query_length]
        rows = torch.arange(j, j + 2)
        return ev._replace(
            index=ev.index.index_put((rows,), torch.tensor(at, dtype=torch.int32)),
            valid=ev.valid.index_put((rows,), torch.tensor(True)),
            n_events=ev.n_events + 2,
            n_pulses=ev.n_pulses.index_put((rows,), torch.tensor(pulses, dtype=torch.int32)),
            noise_var=ev.noise_var.index_put((rows,), ev.noise_var[0]),
            dc=ev.dc.index_put((rows,), ev.dc[0]))

    events = with_tail(y, cfg, flags)
    last = int(events.valid.sum()) - 3
    ack, query = (int(i) for i in events.index[last + 1: last + 3])
    assert ack + cfg.epc_window > n and ack < query
    want_dec = inv.decode_events(y, events, cfg, specialize=True)
    assert (bool(want_dec.epc_fits[last + 1]), bool(want_dec.rn16_fits[last + 2])) == (False, True)
    assert not inv._replay_fast_ok(want_dec, cfg)
    want = inv.replay_inventory_scan(want_dec, cfg)
    monkeypatch.setattr(inv, "gate_detect", with_tail)
    replays, redecodes = _counters()
    stats, dec = inv.decode_block(y, cfg, flags)
    _same(dec, want_dec)
    _same(stats, want)
    assert inv.replays == {"closed_form": replays["closed_form"], "scan": replays["scan"] + 1}
    assert inv.redecodes == redecodes


@pytest.mark.parametrize("broken", [False, True])
def test_batch_replay_reads_every_verdict_once(broken):
    """``replay_inventory_batch`` reads every channel's verdict in one read
    and replays each channel as its own verdict says: two golden tables, the
    second given an unclassifiable event when ``broken``."""
    x2 = inv.to_planar(golden_trace(CFG).iq)
    _, dec = inv.decode_capture_planar(x2, CFG, device="cpu")
    other = dec
    if broken:
        other = dec._replace(cmd_type=dec.cmd_type.index_put(
            (torch.tensor([1]),), torch.tensor(inv.CMD_UNKNOWN, dtype=torch.int32)))
    dec_c = inv.DecodedEvents(*(torch.stack(f) for f in zip(dec, other)))
    replays, _ = _counters()
    with profiling.recording():
        got = inv.replay_inventory_batch(dec_c, CFG)
    assert sum(r["name"] == profiling.HOST_READ for r in profiling.spans()) == 1 + 8 * broken
    assert inv.replays == {"closed_form": replays["closed_form"] + 2 - broken,
                           "scan": replays["scan"] + broken}
    for k, one in enumerate((dec, other)):
        _same(inv.InventoryStats(*(f[k] for f in got)), inv.replay_inventory(one, CFG))
