"""The port's decode and replay against the JAX package, stage by stage and
end to end, on the CPU.

Integer and bool outputs must be equal: event tables, decoded bits, CRC
verdicts, tag ids, slot states, command types and every InventoryStats
field.  Float outputs agree within float32 summation-order noise (the JAX
package filters with XLA's conv and contracts 0/+-1 selection matrices; the
port sums taps in order and gathers): t_half to 1e-6 (a table entry),
h_est and rn16_energy to 1e-4 of their largest magnitude, and the O(1)
rn16_margin to 1e-3 absolute (a mean of differences of nearly equal
samples, where the inputs' last-bit differences are amplified).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp.filters import matched_filter_decimate as ref_mfd
from gen2_rfid_tpu.dsp.gate import gate_detect as _ref_gate_detect
from gen2_rfid_tpu.io.sigmf import load_sigmf
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.runtime.stats import (
    format_results as ref_format_results,
    merge_stats as ref_merge_stats,
)
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import golden_trace, synthesize_inventory
from gen2_rfid_tpu_torch import carry
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime.stats import format_results, merge_stats, unique_tags
from torch_compare import assert_same_decoded, assert_same_stats, port_cfg

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "golden_fm0"

ref_gate_detect = jax.jit(_ref_gate_detect, static_argnames=("cfg",))
ref_decode_block = jax.jit(ref_inv.decode_block, static_argnames=("cfg", "exact_gate"))
ref_decode_events = jax.jit(ref_inv.decode_events,
                            static_argnames=("cfg", "specialize", "overflow_fallback"))
ref_replay = jax.jit(ref_inv.replay_inventory, static_argnames=("cfg",))
ref_replay_scan = jax.jit(ref_inv.replay_inventory_scan, static_argnames=("cfg",))

def port_y(iq, cfg):
    """The port's post-decimation y: the fused front end's plain version."""
    x2 = inv.to_planar(iq)
    y2 = gate_front_for_cfg(x2, cfg)[0]
    return torch.complex(y2[0], y2[1])


def port_decoded_from(ref_dec):
    return inv.DecodedEvents(**{f: torch.from_numpy(np.array(getattr(ref_dec, f)))
                                for f in inv.DecodedEvents._fields})


@pytest.fixture(scope="module")
def golden():
    ref_cfg = RefConfig()
    cfg = port_cfg(ref_cfg)
    tr = golden_trace(ref_cfg)
    stats, dec = inv.decode_capture(tr.iq, cfg, device="cpu")
    ref_stats, ref_dec = ref_inv.decode_capture(jnp.asarray(tr.iq), ref_cfg)
    return cfg, ref_cfg, tr, stats, dec, ref_stats, ref_dec


# ---- the golden trace ---------------------------------------------------

def test_golden_tuple_and_report(golden):
    _, _, _, stats, _, ref_stats, _ = golden
    assert int(stats.n_queries) == 71
    assert int(stats.cur_inventory_round) == 72
    assert int(stats.n_epc_correct) == 70
    assert unique_tags(stats) == 1
    assert int(stats.tag_reads[0x1B]) == 70
    assert format_results(stats) == ref_format_results(ref_stats)


def test_golden_stats_equal_default_path(golden):
    _, _, _, stats, _, ref_stats, _ = golden
    assert_same_stats(stats, ref_stats)


def test_golden_decoded_events_equal_default_path(golden):
    _, _, _, _, dec, _, ref_dec = golden
    assert_same_decoded(dec, ref_dec)


def test_golden_equals_decode_block_on_port_y(golden):
    """The port's pipeline is the JAX decode_block run on the port's y."""
    cfg, ref_cfg, tr, stats, dec, _, _ = golden
    y = port_y(tr.iq, cfg)
    ref_stats, ref_dec = ref_decode_block(jnp.asarray(y.numpy()), ref_cfg)
    assert_same_decoded(dec, ref_dec)
    assert_same_stats(stats, ref_stats)


def test_golden_rn16s_match_truth(golden):
    _, _, tr, _, dec, _, _ = golden
    valid = dec.valid.numpy()
    rn16 = dec.rn16_bits.numpy()[valid]
    queries = [e for e in tr.events if e.kind in ("query", "query_rep")]
    assert len(queries) == 71
    for k, ev in enumerate(queries):
        np.testing.assert_array_equal(rn16[2 * k], ev.reply_bits)


def test_stage_isolation_reference_events_into_port_decode(golden):
    """The JAX gate's events, carried into the port's decode_events, decode
    to the JAX decode_events' results: the decode stage alone agrees."""
    cfg, ref_cfg, tr, _, _, _, _ = golden
    y_ref = ref_mfd(jnp.asarray(tr.iq), ref_inv.matched_taps(ref_cfg), ref_cfg.decim)
    ref_events = ref_gate_detect(y_ref, ref_cfg)
    want = ref_decode_events(y_ref, ref_events, ref_cfg, specialize=True)
    events = carry.events_from_numpy(ref_events)
    got = inv.decode_events(torch.from_numpy(np.array(y_ref)), events, cfg,
                            specialize=True)
    assert_same_decoded(got, want)
    assert_same_stats(inv.replay_inventory(got, cfg), ref_replay(want, ref_cfg))


def test_paranoid_decode_matches_reference(golden):
    cfg, ref_cfg, tr, _, _, _, _ = golden
    y = port_y(tr.iq, cfg)
    ref_events = ref_gate_detect(jnp.asarray(y.numpy()), ref_cfg)
    want = ref_decode_events(jnp.asarray(y.numpy()), ref_events, ref_cfg,
                             specialize=False)
    got = inv.decode_events(y, carry.events_from_numpy(ref_events), cfg,
                            specialize=False)
    assert_same_decoded(got, want)


def test_golden_replay_fast_equals_scan(golden):
    cfg, _, _, stats, dec, _, _ = golden
    assert inv._replay_fast_ok(dec, cfg)
    assert_same_stats(inv.replay_inventory_scan(dec, cfg), stats)


def test_golden_decode_counts_one_closed_form_replay(golden):
    cfg, _, tr, stats, _, _, _ = golden
    before = dict(inv.replays)
    got, _ = inv.decode_capture(tr.iq, cfg, device="cpu")
    assert inv.replays == {"closed_form": before["closed_form"] + 1, "scan": before["scan"]}
    assert_same_stats(got, stats)


# ---- other captures -----------------------------------------------------

def _end_to_end(ref_cfg, iq):
    cfg = port_cfg(ref_cfg)
    stats, dec = inv.decode_capture(iq, cfg, device="cpu")
    ref_stats, ref_dec = ref_inv.decode_capture(jnp.asarray(iq), ref_cfg)
    assert_same_stats(stats, ref_stats)
    assert_same_decoded(dec, ref_dec)
    assert format_results(stats) == ref_format_results(ref_stats)
    return stats, dec


def test_multitag_q2_scene():
    """tests/test_golden.py's FIXED_Q=2 scene: singletons decode, empty and
    collided slots fail CRC."""
    ref_cfg = RefConfig(fixed_q=2)
    tags = [RefTag.with_id(i + 1, seed=i, backscatter=0.08 + 0.02j) for i in range(3)]
    tr = synthesize_inventory(ref_cfg, tags, n_rounds=6, seed=5)
    stats, _ = _end_to_end(ref_cfg, tr.iq)
    assert int(stats.n_queries) == 24 and int(stats.cur_inventory_round) == 7
    assert int(stats.n_epc_correct) == tr.expected_epc_pass
    for tid, cnt in tr.expected_tag_reads.items():
        assert int(stats.tag_reads[tid]) == cnt
    assert int(stats.n_slot_empty) + int(stats.n_slot_collision) > 0


def test_golden_fm0_sigmf_fixture():
    """The committed SigMF capture (ci16 quantized) decodes to its pinned stats."""
    iq, meta = load_sigmf(str(FIXTURE))
    ref_cfg = RefConfig(max_events=64)
    assert meta["global"]["core:sample_rate"] == ref_cfg.adc_rate
    stats, _ = _end_to_end(ref_cfg, iq)
    want = json.loads(FIXTURE.with_suffix(".expect.json").read_text())
    reads = stats.tag_reads.numpy()
    assert {"n_queries": int(stats.n_queries), "n_epc_correct": int(stats.n_epc_correct),
            "round": int(stats.cur_inventory_round),
            "tag_reads": {str(t): int(reads[t]) for t in np.nonzero(reads)[0]}} == {
        k: want[k] for k in ("n_queries", "n_epc_correct", "round", "tag_reads")}


def test_truncated_tail():
    """Capture cut inside an EPC window: the trailing unfit event is handled
    as the reference handles it."""
    ref_cfg = RefConfig(max_events=64)
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(5, seed=2)], n_rounds=4, seed=3)
    stats, dec = _end_to_end(ref_cfg, tr.iq[: tr.events[-1].cmd_end + 800])
    assert not bool(dec.epc_fits[int(dec.valid.sum()) - 1])


# ---- fallbacks ----------------------------------------------------------

def _anomaly_scene(n_rounds=8, seed=11, max_events=64):
    ref_cfg = RefConfig(max_events=max_events)
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(27, seed=7)],
                              n_rounds=n_rounds, seed=seed)
    cfg = port_cfg(ref_cfg)
    y = port_y(tr.iq, cfg)
    return cfg, ref_cfg, y, ref_gate_detect(jnp.asarray(y.numpy()), ref_cfg)


def test_overflow_falls_back_to_paranoid_decode():
    """tests/test_anomalies.py's overflow case: every event forced to Query
    overflows the per-role capacity and takes the paranoid decode."""
    cfg, ref_cfg, y, ref_events = _anomaly_scene(n_rounds=24, seed=9)
    cfg = dataclasses.replace(cfg, max_events=52)
    ref_cfg = dataclasses.replace(ref_cfg, max_events=52)
    ref_events = ref_gate_detect(jnp.asarray(y.numpy()), ref_cfg)
    assert int(ref_events.n_events) == 48
    ref_events = ref_events._replace(n_pulses=jnp.full_like(ref_events.n_pulses, 26))
    want = ref_decode_events(jnp.asarray(y.numpy()), ref_events, ref_cfg, specialize=True)
    got = inv.decode_events(y, carry.events_from_numpy(ref_events), cfg, specialize=True)
    assert_same_decoded(got, want)
    valid = got.valid.numpy()
    assert got.rn16_energy.numpy()[valid][-1] > 0
    stats = inv.replay_inventory_scan(got, cfg)
    assert_same_stats(stats, ref_replay_scan(want, ref_cfg))
    assert int(stats.n_queries) == 48 and int(stats.n_epc_correct) == 0


def _spurious_table():
    """tests/test_anomalies.py's injected unclassifiable event: the table
    decoded by the port and by the reference."""
    cfg, ref_cfg, y, ev = _anomaly_scene()
    idx = np.asarray(ev.index)
    j = int(ev.n_events)
    ev = ev._replace(
        index=ev.index.at[j].set(int(idx[1]) + ref_cfg.epc_window + 40),
        valid=ev.valid.at[j].set(True), n_pulses=ev.n_pulses.at[j].set(2),
        noise_var=ev.noise_var.at[j].set(ev.noise_var[0]), dc=ev.dc.at[j].set(ev.dc[0]))
    order = jnp.argsort(ev.index)
    ev = jax.tree.map(lambda a: a[order] if a.ndim == 1 else a, ev)
    want_dec = ref_decode_events(jnp.asarray(y.numpy()), ev, ref_cfg, specialize=True)
    dec = inv.decode_events(y, carry.events_from_numpy(ev), cfg, specialize=True)
    return cfg, ref_cfg, dec, want_dec


def test_spurious_event_forces_scan_replay():
    """tests/test_anomalies.py's injected unclassifiable event: the closed
    form's preconditions fail, the sequential scan replays the table, and
    the stats equal the reference's."""
    cfg, ref_cfg, dec, want_dec = _spurious_table()
    assert_same_decoded(dec, want_dec)
    assert int(dec.cmd_type[2]) == inv.CMD_UNKNOWN
    assert not inv._replay_fast_ok(dec, cfg)
    stats = inv.replay_inventory(dec, cfg)
    assert_same_stats(stats, ref_replay(want_dec, ref_cfg))
    assert int(stats.n_epc_correct) == 8


def test_spurious_event_counts_one_scan_replay():
    cfg, _, dec, _ = _spurious_table()
    before = dict(inv.replays)
    inv.replay_inventory(dec, cfg)
    assert inv.replays == {"closed_form": before["closed_form"], "scan": before["scan"] + 1}


@pytest.mark.parametrize("drop", [(5,), (4,), (2, 3, 9)])
def test_dropped_events_replay(drop):
    """A malformed table with events dropped: the port's replay (and its
    scan, run on the same table) equals the reference's."""
    cfg, ref_cfg, y, ev = _anomaly_scene()
    for k in drop:
        ev = ev._replace(valid=ev.valid.at[k].set(False))
    want_dec = ref_decode_events(jnp.asarray(y.numpy()), ev, ref_cfg, specialize=True)
    dec = inv.decode_events(y, carry.events_from_numpy(ev), cfg, specialize=True)
    assert_same_decoded(dec, want_dec)
    want = ref_replay(want_dec, ref_cfg)
    assert_same_stats(inv.replay_inventory(dec, cfg), want)
    assert_same_stats(inv.replay_inventory_scan(dec, cfg), ref_replay_scan(want_dec, ref_cfg))


@pytest.mark.parametrize("limit", [dict(max_num_queries=5), dict(max_unique_tags=0)])
def test_termination_limits_scan(limit):
    """Termination limits send the replay to the scan; the port's scan on
    the reference's own decoded table gives the reference's stats."""
    ref_cfg = RefConfig(max_events=64, **limit)
    tr = synthesize_inventory(ref_cfg, [RefTag.with_id(5, seed=2)], n_rounds=10, seed=3)
    _, ref_dec = ref_inv.decode_capture(jnp.asarray(tr.iq), ref_cfg)
    cfg = port_cfg(ref_cfg)
    dec = port_decoded_from(ref_dec)
    assert not inv._replay_fast_ok(dec, cfg)
    stats = inv.replay_inventory(dec, cfg)
    assert_same_stats(stats, ref_replay_scan(ref_dec, ref_cfg))
    assert bool(stats.terminated)


def test_merge_stats_matches_reference(golden):
    _, _, _, stats, _, ref_stats, _ = golden
    assert_same_stats(merge_stats(stats, stats), ref_merge_stats(ref_stats, ref_stats))


# ---- entry-point contract -----------------------------------------------

def test_no_device_without_cuda_raises(monkeypatch, golden):
    _, _, tr, _, _, _, _ = golden
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inv.decode_capture(tr.iq[:20000], ReaderConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inv.decode_capture_planar(inv.to_planar(tr.iq[:20000]), ReaderConfig())


def test_configs_outside_the_slice_raise():
    """Miller, the last configuration outside the port's slices, no longer
    raises: a capture that is all carrier decodes to no events."""
    iq = np.ones(20000, np.complex64)
    for kw in (dict(miller_m=4), dict(miller_m=8, trext=1, adc_rate=8e6, decim=2)):
        stats, dec = inv.decode_capture(iq, ReaderConfig(max_events=16, **kw), device="cpu")
        assert int(stats.n_events) == 0 and not bool(dec.valid.any())
        assert int(stats.n_queries) == 0 and int(stats.cur_inventory_round) == 1


@pytest.mark.parametrize("kw,exact_gate", [
    (dict(mode="compat"), False), (dict(epc_softfix=8), False),
    (dict(track_channel=True), False), (dict(cancel_cw=2), False), (dict(), True)])
def test_configs_of_the_slice_decode(kw, exact_gate):
    """Every FM0 switch decodes; a capture that is all carrier has no events."""
    iq = np.ones(20000, np.complex64)
    stats, dec = inv.decode_capture(iq, ReaderConfig(max_events=16, **kw),
                                    exact_gate=exact_gate, device="cpu")
    assert int(stats.n_events) == 0 and not bool(dec.valid.any())
    assert int(stats.n_queries) == 0 and int(stats.cur_inventory_round) == 1


def test_carry_round_trips(golden):
    cfg, ref_cfg, _, _, dec, _, ref_dec = golden
    assert carry.config_from_fields(dataclasses.asdict(ref_cfg)) == cfg
    with pytest.raises(ValueError):
        carry.config_from_fields({"no_such_field": 1})
    back = carry.decoded_to_numpy(port_decoded_from(ref_dec))
    for f in inv.DecodedEvents._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(ref_dec, f)))
