"""The plain reference against the port's CPU decode and against what the
synthesizer sent, its pieces on their own, and the comparison against the
control it has to reject."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gen2_rfid_tpu_torch.config import ReaderConfig as PortConfig
from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar
from rfidbench import judge
from rfidbench.reference.decode import (SlotRule, check_epc, command_pulses, command_type,
                                        decode_capture)
from rfidbench.reference.front import walk_gate
from rfidbench.synth.config import ReaderConfig
from rfidbench.synth.protocol.crc import crc16_bits
from rfidbench.synth.sim.tag import Tag, tag_id_of_frame
from rfidbench.synth.sim.trace import synthesize_inventory

from .conftest import MILLER, TINY_WORKLOAD, faults_are_the_truths, file_config

CONFIGS = {name: file_config(name) for name in ("fm0_blf40_2msps", MILLER)}
LIMITS = TINY_WORKLOAD["limits"]


def inventory(kw, seed, rounds=3, synth=None):
    cfg = ReaderConfig(**kw)
    tr = synthesize_inventory(cfg, [Tag.with_id(27, seed=7)], n_rounds=rounds, seed=seed,
                              **(synth or {}))
    x2 = torch.from_numpy(np.stack([tr.iq.real, tr.iq.imag]).astype(np.float32))
    taps = int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)
    truth = judge.Truth(tr.events, x2.shape[1], 1, cfg.decim, max(cfg.n_samples_pw, 1),
                        cfg.n_samples_t1 + 1 + (taps - 1) / (2 * cfg.decim))
    return x2, truth


def capture(kw, seed, rounds=3, synth=None):
    return inventory(kw, seed, rounds, synth)[0]


def checks(got, want, truth=None):
    return judge.checks([judge.compare(*got, *want, truth)], 0, LIMITS)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_equals_the_port(name):
    """The reference, computed apart in float64 and its slots by the
    configuration's rule, is what the synthesizer sent; the port's CPU
    decode agrees with it on every event, float (within a tenth of the
    limit) and EPC count, and where its decoded rows or stats differ they
    differ from what was sent too, in slot verdicts alone.  At FM0, whose
    rule the port applies, they agree everywhere."""
    fields, rule, synth = CONFIGS[name]
    kw = dict(fields, max_events=64)
    x2, truth = inventory(kw, 2 ** 31 + 3, synth=synth)
    got = decode_capture_planar(x2, PortConfig(**kw), device="cpu")
    want = decode_capture(x2, ReaderConfig(**kw), slot_rule=rule)
    assert got[0]._fields == want[0]._fields and got[1]._fields == want[1]._fields
    assert int(want[0].n_epc_correct) == 3
    result = faults_are_the_truths(got, want, truth, LIMITS)
    assert 0 < result["float_gap"] < LIMITS["float_gap"] / 10
    if name.startswith("fm0"):
        assert judge.passed(checks(got, want, truth)), result


def test_truth_sees_the_miller_slot_verdict():
    """The ground truth, no program: at Miller-4 the FM0 rule calls every
    slot a lone tag answered a collision (its RN16 window reads about 1.7
    |h|^2, over the 0.42 |h|^2 that rule allows), and ``truth_rows`` counts
    each one; under the configuration's own rule it counts none."""
    fields, rule, synth = CONFIGS[MILLER]
    assert rule != SlotRule()
    kw = dict(fields, max_events=64)
    x2, truth = inventory(kw, 2 ** 31 + 3, rounds=4, synth=synth)
    cfg = ReaderConfig(**kw)
    stats, dec = decode_capture(x2, cfg)
    assert int(stats.n_slot_collision) == 4 and int(stats.n_slot_single) == 0
    assert int(stats.n_epc_correct) == 4
    assert judge.truth_rows(dec, truth) == 4
    stats, dec = decode_capture(x2, cfg, slot_rule=rule)
    assert int(stats.n_slot_single) == 4 and int(stats.n_slot_collision) == 0
    assert judge.truth_rows(dec, truth) == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rejects_outputs_rounded_to_bfloat16(name):
    kw = dict(CONFIGS[name][0], max_events=64)
    x2 = capture(kw, 5, synth=CONFIGS[name][2])
    stats, dec = decode_capture(x2, ReaderConfig(**kw))
    rounded = dec._replace(**{f: getattr(dec, f).to(torch.bfloat16).to(torch.float64)
                              for f in judge.FLOAT_FIELDS})
    result = checks((stats, rounded), (stats, dec))
    assert not judge.passed(result) and result["float_gap"]["value"] > LIMITS["float_gap"]


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_control_fails(name, seed):
    """The control, the reference with its front end in bfloat16, is not
    correct: its float gap is well over the limit."""
    kw = dict(CONFIGS[name][0], max_events=64)
    cfg = ReaderConfig(**kw)
    x2 = capture(kw, seed, rounds=4, synth=CONFIGS[name][2])
    result = checks(decode_capture(x2, cfg, front_dtype=torch.bfloat16), decode_capture(x2, cfg))
    assert not judge.passed(result) and result["float_gap"]["value"] > 10 * LIMITS["float_gap"]


def test_refuses_other_modes():
    with pytest.raises(ValueError):
        decode_capture(capture({}, 1), ReaderConfig(mode="compat"))


def test_crc_passes_sent_frames_and_fails_a_flipped_bit():
    frames = np.stack([Tag.with_id(i, seed=i).epc_frame_bits() for i in (1, 27, 200)])
    assert np.array_equal(frames[:, -16:], np.stack([crc16_bits(f[:-16]) for f in frames]))
    ok, tid = check_epc(frames.astype(np.int64))
    assert ok.all() and list(tid) == [tag_id_of_frame(f) for f in frames] == [1, 27, 200]
    flipped = frames.copy()
    flipped[:, 40] ^= 1
    assert not check_epc(flipped.astype(np.int64))[0].any()


def test_gate_walk():
    """Pulses are rises after pw_half+1 samples below; the count resets on a
    short-gap rise and on nt1+1 samples of carrier; a command of more than
    min_pulses pulses followed by nt1+1 samples of carrier triggers
    nt1+1 samples after its last rise."""
    pw_half, nt1 = 2, 6
    cw = [1] * 10

    def pulses(k, gap=3):
        return ([0] * gap + [1] * 2) * k

    above = np.array(cw + pulses(6) + cw + pulses(4) + cw + pulses(3) + [0] + [1] * 2
                     + pulses(3) + cw, dtype=bool)
    trig, count = walk_gate(above, pw_half, nt1, 5)
    last_rise = 10 + 5 * 6 - 2
    assert trig == [last_rise + nt1 + 1] and count == [6]
    second = last_rise + 10 + 5 * 4
    assert walk_gate(above, pw_half, nt1, 3) == ([last_rise + nt1 + 1, second + nt1 + 1], [6, 4])


def test_command_types():
    cfg = ReaderConfig()
    expected = command_pulses(cfg)
    assert [command_type(p, expected) for p in (26, 25, 27, 7, 8, 21, 12, 11, 16, 0)] == [
        0, 0, 0, 1, 1, 2, 3, 4, 5, 5]
