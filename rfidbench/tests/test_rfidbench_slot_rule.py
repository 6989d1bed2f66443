"""A configuration's ``slot_rule``: read by the harness from the
configuration file, handed to the reference's slot verdict, the same
verdicts as before where a file gives none, and refused where malformed."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rfidbench import judge
from rfidbench.cells import ROOT, captures, generator, load_cell, reader_fields, slot_rule
from rfidbench.reference.decode import SlotRule, decode_capture, replay, slot_state
from rfidbench.slot_bands import inventory
from rfidbench.synth.config import ReaderConfig

from .conftest import MILLER, SLOT_STATS, add_tiny_cell, judged_run

FM0_RULE = {"margin_min": 0.68, "excess": [0.0, 0.42],
            "why": "the rule fitted to FM0, written out"}
# The rule the Miller-4 file states, as the file states it.
MILLER_RULE = json.loads((ROOT / "configs" / f"{MILLER}.json").read_text())["slot_rule"]
NOISES = (0.004, 0.016, 0.032)


def add_config(root, base: str, name: str, rule=None, **fields) -> None:
    """``configs/<name>.json`` under ``root``: the repository's ``base``
    configuration with ``fields`` set in its reader configuration and
    ``rule`` as its ``slot_rule``, or no ``slot_rule`` where ``rule`` is
    None."""
    cfg = json.loads((ROOT / "configs" / f"{base}.json").read_text())
    cfg["name"] = name
    cfg["reader_config"].update(fields)
    cfg.pop("slot_rule", None)
    if rule is not None:
        cfg["slot_rule"] = rule
    (root / "configs").mkdir(exist_ok=True)
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))


def verdict_by(rule: SlotRule):
    """A wrap of the program's entry (``judged_run``'s ``wrap``) that gives
    its slots the verdict of ``rule`` from outside the program: each RN16
    window the program called occupied gets the reference's ``slot_state``
    under ``rule`` over the program's own power, margin and channel, and
    the stats the replay derives from slot_state are counted again over
    them by the reference's ``replay``.  The file's rule stands for a
    program whose verdict is repaired per M; ``SlotRule()``, for one that
    applies the FM0 rule at every link."""
    def wrap(entry, scfg):
        def decode(x2):
            stats, dec = entry(x2)
            h = torch.complex(dec.h_est[:, 0].double(), dec.h_est[:, 1].double())
            energy = dec.rn16_energy.double()
            state = slot_state(energy, dec.rn16_margin.double(), torch.zeros_like(energy), h,
                               rule)
            dec = dec._replace(slot_state=torch.where(dec.slot_state > 0, state.to(
                dec.slot_state.dtype), dec.slot_state))
            counts = replay(dec, scfg)
            return stats._replace(**{f: getattr(counts, f).to(getattr(stats, f))
                                     for f in SLOT_STATS}), dec
        return decode
    return wrap


def cell_of(root, config: str):
    return load_cell(f"tiny.{config}", add_tiny_cell(root, config), root)


def old_slot_state(energy, margin, noise_var, h):
    """The reference's slot verdict before configurations gave the rule."""
    occupied = energy >= 4.0 * noise_var
    collision = (margin < 0.68) | (energy > 0.42 * torch.clamp(h.abs() ** 2, min=1e-12))
    return torch.where(occupied, torch.where(collision, 2, 1), 0)


@pytest.mark.parametrize("base", ["fm0_blf40_2msps", MILLER])
def test_no_rule_is_the_fm0_rule_written_out(tmp_path, base):
    """A configuration without ``slot_rule`` decodes bit for bit as the same
    configuration with today's constants written out."""
    add_config(tmp_path, base, "no_rule")
    add_config(tmp_path, base, "written_out", FM0_RULE)
    plain, written = cell_of(tmp_path, "no_rule"), cell_of(tmp_path, "written_out")
    assert plain.slot_rule == written.slot_rule == SlotRule()
    scfg = ReaderConfig(**reader_fields(plain))
    caps = captures(plain, scfg, 2 ** 31 + 17, torch.device("cpu"))
    for cap in caps:
        a = decode_capture(cap.x2, scfg, slot_rule=plain.slot_rule)
        b = decode_capture(cap.x2, scfg, slot_rule=written.slot_rule)
        for x, y in zip(a, b):
            for f in x._fields:
                assert torch.equal(getattr(x, f), getattr(y, f)), f
        assert int(a[0].n_queries) > 0


def test_boundaries_keep_the_old_verdicts():
    """Powers exactly at 4 x noise and 0.42 |h|^2 and margins exactly at 0.68,
    and a step either side, get the verdicts the old function gave; a band's
    edges are inside it."""
    # The last four are channels where power / |h|^2 rounds across 0.42, 1.6
    # (up, then down) and 1.9 where the power is that multiple of |h|^2.
    h = torch.tensor([0.3 + 0.4j, 1e-7 + 0j, 0.05 - 0.02j, 1.7 + 0.9j,
                      0.09401229776087457 - 0.5900893871187699j,
                      -0.535669373161111 - 1.680333677376483j,
                      0.2201951234700494 + 0.8276465583323251j,
                      -0.1321048632913019 - 0.5022445517110371j], dtype=torch.complex128)
    h2 = torch.clamp(h.abs() ** 2, min=1e-12)
    noise = torch.full_like(h2, 1e-4)
    at = torch.stack([0.42 * h2, 4.0 * noise])
    energy = torch.stack([torch.nextafter(at, at * 0), at, torch.nextafter(at, at * 2)]
                         ).reshape(-1)
    for m in (0.68, float(np.nextafter(0.68, 0)), float(np.nextafter(0.68, 1)), 2.0):
        margin = torch.full_like(energy, m)
        args = (energy, margin, noise.repeat(6), h.repeat(6))
        assert torch.equal(slot_state(*args), old_slot_state(*args))
        assert torch.equal(slot_state(*args, SlotRule()), old_slot_state(*args))
    band = SlotRule(0.0, (1.6, 1.9))
    edges = torch.stack([1.6 * h2, 1.9 * h2, torch.nextafter(1.6 * h2, h2 * 0),
                         torch.nextafter(1.9 * h2, h2 * 4)]).reshape(-1)
    got = slot_state(edges, torch.ones_like(edges), torch.zeros(edges.numel()), h.repeat(4), band)
    assert got.tolist() == [1] * 2 * h.numel() + [2] * 2 * h.numel()


@pytest.mark.parametrize("seed", [3, 17, 29])
def test_a_miller_band_added_as_a_file_mends_the_verdict(tmp_path, seed):
    """The Miller-4 configuration at the spec's link (DR 64/3, TRcal 133
    us, BLF 160 kHz at 40 kbps) with the band its file states: on four tags
    at ``fixed_q`` 2 (``slot_bands``' inventory), at every noise the band
    was fitted over and with the tags at one phase or spread, the
    reference's slots are what the synthesizer sent.  The same file without
    its rule calls every slot one tag answered alone a collision."""
    add_config(tmp_path, MILLER, "miller4_band", MILLER_RULE, fixed_q=2)
    add_config(tmp_path, MILLER, "miller4_plain", fixed_q=2)
    band, plain = cell_of(tmp_path, "miller4_band"), cell_of(tmp_path, "miller4_plain")
    assert band.slot_rule == SlotRule(MILLER_RULE["margin_min"], tuple(MILLER_RULE["excess"]))
    assert plain.slot_rule == SlotRule()
    cfg = ReaderConfig(**reader_fields(band))
    assert cfg == ReaderConfig(**reader_fields(plain))
    assert cfg.dr == 1 and abs(cfg.blf_from_trcal / (cfg.miller_m * cfg.blf_hz) - 1) < 0.01
    for noise in NOISES:
        for step in (None, 1.1):
            x2, truth = inventory(cfg, seed, noise, step, band.synthesizer)
            lone = np.array([e.kind in ("query", "query_rep") and e.reply_tag is not None
                             and e.reply_bits is not None for e in truth.events])
            assert lone.sum() == {3: 9, 17: 7, 29: 11}[seed]
            stats, dec = decode_capture(x2, cfg, slot_rule=band.slot_rule)
            assert judge.truth_rows(dec, truth) == 0, (noise, step)
            assert int(stats.n_slot_single) == int(stats.n_epc_correct) == lone.sum()
            stats, dec = decode_capture(x2, cfg, slot_rule=plain.slot_rule)
            found, rows = judge.sent_rows(dec, truth)
            assert found[0][lone].all() and (dec.slot_state[rows[0][lone]] == 2).all()
            assert judge.truth_rows(dec, truth) >= lone.sum()


@pytest.mark.parametrize("rule", [
    {**FM0_RULE, "energy_factor": 4.0},
    {k: v for k, v in FM0_RULE.items() if k != "margin_min"},
    {**FM0_RULE, "excess": [0.5, 0.42]},
    {**FM0_RULE, "margin_min": "0.68"},
    {**FM0_RULE, "margin_min": True},
    {**FM0_RULE, "excess": [0.42]},
    {**FM0_RULE, "excess": 0.42},
    [4.0, 0.68, [0.0, 0.42]],
], ids=["unknown_key", "missing_number", "low_over_high", "string", "bool", "one_edge",
        "not_a_pair", "not_an_object"])
def test_malformed_rule_is_refused(tmp_path, rule):
    add_config(tmp_path, "fm0_blf40_2msps", "malformed", rule)
    with pytest.raises(ValueError, match="malformed.json"):
        cell_of(tmp_path, "malformed")


@pytest.mark.parametrize("synth", [
    {"tag_t1_us": 130, "t1_us": 128},
    {"tag_t1_us": "130"},
    {"tag_t1_us": True},
    {"tag_t1_us": 0},
    {"tag_t1_us": float("nan")},
    [130],
], ids=["unknown_key", "string", "bool", "zero", "nan", "not_an_object"])
def test_malformed_synthesizer_is_refused(tmp_path, synth):
    add_config(tmp_path, "fm0_blf40_2msps", "malformed")
    path = tmp_path / "configs" / "malformed.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "synthesizer": synth}))
    with pytest.raises(ValueError, match="malformed.json"):
        cell_of(tmp_path, "malformed")


def test_the_tag_delay_reaches_the_synthesizer(tmp_path):
    """A configuration's ``synthesizer`` keywords reach the synthesizer
    through the cell's captures: the Miller-4 file's ``tag_t1_us`` moves
    its replies off where the synthesizer's default puts them, and a file
    without the key keeps that default."""
    cell = cell_of(tmp_path, MILLER)
    assert cell.synthesizer == {"tag_t1_us": 130.0}
    assert cell_of(tmp_path, "fm0_blf40_2msps").synthesizer == {}
    scfg = ReaderConfig(**reader_fields(cell))
    args = (cell.traffic, scfg, 2 ** 31 + 5, torch.device("cpu"))
    got = captures(cell, *args[1:])
    given = generator(cell).make(*args, tag_t1_us=130.0)
    default = generator(cell).make(*args)
    for a, b, c in zip(got, given, default, strict=True):
        assert torch.equal(a.x2, b.x2) and not torch.equal(a.x2, c.x2)


def test_run_and_control_hand_the_rule_to_the_reference(tmp_path):
    """A whole run and the control's readings judge the program by the
    configuration's rule: the reference they hold the port to is what the
    synthesizer sent, and where the port's rows differ from it they differ
    from what was sent as often (``faults_are_the_truths``)."""
    from rfidbench.control import readings

    cell = cell_of(tmp_path, MILLER)
    assert cell.slot_rule != SlotRule()
    checks = judged_run(cell, 2 ** 31 + 3, 0.3, torch.device("cpu"))["checks"]
    assert checks["decode_rows"]["value"] == checks["truth_rows"]["value"]
    assert checks["event_rows"]["value"] == 0
    ((_, prog, _),) = readings(cell, [2 ** 31 + 3], torch.device("cpu"))
    assert prog["decode_rows"]["value"] == prog["truth_rows"]["value"] == checks[
        "truth_rows"]["value"]
    assert prog["stats_fields"]["value"] == checks["stats_fields"]["value"]


def test_a_repaired_port_passes_unchanged(tmp_path):
    """The harness takes a port whose slot verdict is repaired per M with no
    edit of its own: the Miller-4 file's tiny cell, the port's slots given
    the file's rule (``verdict_by``), is ``correct``.  With the FM0 rule at
    every link in its place, the run is not, and every decoded row it gets
    wrong is one the ground truth counts."""
    cell = cell_of(tmp_path, MILLER)
    assert reader_fields(cell)["miller_m"] > 1
    for rule, correct in ((cell.slot_rule, True), (SlotRule(), False)):
        result = judged_run(cell, 2 ** 31 + 11, 0.3, torch.device("cpu"), verdict_by(rule))
        checks = {k: c["value"] for k, c in result["checks"].items()}
        assert result["correct"] is correct, checks
        assert checks["decode_rows"] == checks["truth_rows"]
        assert (checks["truth_rows"] > 0) is not correct, checks


def test_slot_bands_table(capsys):
    """``python -m rfidbench.slot_bands`` at one noise and seed: a row for
    each link and tag set, and no collided window that a rule fitted to the
    lone ones would call single."""
    from rfidbench.slot_bands import LINKS, PHASES, main

    assert main(["--noises", "0.004", "--seeds", "3"]) == 0
    rows = capsys.readouterr().out.splitlines()[2:]
    assert len(rows) == len(LINKS) * len(PHASES)
    assert all(r.split("|")[7].strip() == "0" for r in rows), rows
    # ``--fit`` at one noise and seed: a rule the harness takes, inside the
    # Miller-4 file's, which was fitted over more noises and seeds.
    assert main(["--fit", "miller4", "--noises", "0.004", "--seeds", "3"]) == 0
    fitted = json.loads(capsys.readouterr().out)
    rule = slot_rule({"slot_rule": fitted}, "fitted")
    assert fitted["why"].endswith("the rule calls 0 collided single")
    assert MILLER_RULE["margin_min"] <= rule.margin_min
    assert MILLER_RULE["excess"][0] <= rule.excess[0] <= rule.excess[1] <= MILLER_RULE["excess"][1]
