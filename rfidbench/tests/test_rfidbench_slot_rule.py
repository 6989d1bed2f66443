"""A configuration's ``slot_rule``: read by the harness from the
configuration file, handed to the reference's slot verdict, the same
verdicts as before where a file gives none, and refused where malformed."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rfidbench import judge
from rfidbench.cells import ROOT, generator, load_cell, reader_fields
from rfidbench.reference.decode import SlotRule, decode_capture, slot_state
from rfidbench.slot_bands import inventory
from rfidbench.synth.config import ReaderConfig

from .conftest import add_tiny_cell

FM0_RULE = {"margin_min": 0.68, "excess": [0.0, 0.42],
            "why": "the rule fitted to FM0, written out"}
# A lone Miller tag's RN16 window reads about 1.7 |h|^2 with a margin over 2;
# collided ones read under 1.6 or over 1.9, or a margin under 2.
MILLER_BAND = {"margin_min": 2.0, "excess": [1.6, 1.9],
               "why": "the band a lone Miller-4 tag reads in"}


def add_config(root, base: str, name: str, rule=None, **fields) -> None:
    """``configs/<name>.json`` under ``root``: the repository's ``base``
    configuration with ``fields`` set in its reader configuration and
    ``rule`` as its ``slot_rule``."""
    cfg = json.loads((ROOT / "configs" / f"{base}.json").read_text())
    cfg["name"] = name
    cfg["reader_config"].update(fields)
    if rule is not None:
        cfg["slot_rule"] = rule
    (root / "configs").mkdir(exist_ok=True)
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))


def cell_of(root, config: str):
    return load_cell(f"tiny.{config}", add_tiny_cell(root, config), root)


def old_slot_state(energy, margin, noise_var, h):
    """The reference's slot verdict before configurations gave the rule."""
    occupied = energy >= 4.0 * noise_var
    collision = (margin < 0.68) | (energy > 0.42 * torch.clamp(h.abs() ** 2, min=1e-12))
    return torch.where(occupied, torch.where(collision, 2, 1), 0)


@pytest.mark.parametrize("base", ["fm0_blf40_2msps", "miller4_blf40_2msps"])
def test_no_rule_is_the_fm0_rule_written_out(tmp_path, base):
    """A configuration without ``slot_rule`` decodes bit for bit as the same
    configuration with today's constants written out."""
    add_config(tmp_path, base, "written_out", FM0_RULE)
    plain, written = cell_of(tmp_path, base), cell_of(tmp_path, "written_out")
    assert plain.slot_rule == written.slot_rule == SlotRule()
    scfg = ReaderConfig(**reader_fields(plain))
    caps = generator(plain).make(plain.traffic, scfg, 2 ** 31 + 17, torch.device("cpu"))
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
    """A Miller-4 configuration added only as a file (the link that matches
    the spec: DR 64/3, TRcal 133 us, BLF 160 kHz at 40 kbps) with its band
    in ``slot_rule``: on four tags at ``fixed_q`` 2 (``slot_bands``'
    inventory) the reference's slots are what the synthesizer sent.
    Without the rule, every slot one tag answered alone is a collision."""
    add_config(tmp_path, "miller4_blf40_2msps", "miller4_band", MILLER_BAND, dr=1,
               trcal_us=133, fixed_q=2)
    add_config(tmp_path, "miller4_blf40_2msps", "miller4_plain", dr=1, trcal_us=133, fixed_q=2)
    band, plain = cell_of(tmp_path, "miller4_band"), cell_of(tmp_path, "miller4_plain")
    assert band.slot_rule == SlotRule(2.0, (1.6, 1.9))
    cfg = ReaderConfig(**reader_fields(band))
    assert cfg == ReaderConfig(**reader_fields(plain))
    assert abs(cfg.blf_from_trcal / (cfg.miller_m * cfg.blf_hz) - 1) < 0.01
    x2, truth = inventory(cfg, seed)
    lone = sum(e.kind in ("query", "query_rep") and e.reply_tag is not None
               and e.reply_bits is not None for e in truth.events)
    assert lone == {3: 9, 17: 7, 29: 11}[seed]
    stats, dec = decode_capture(x2, cfg, slot_rule=band.slot_rule)
    assert judge.truth_rows(dec, truth) == 0
    assert int(stats.n_slot_single) == int(stats.n_epc_correct) == lone > 0
    stats, dec = decode_capture(x2, cfg, slot_rule=plain.slot_rule)
    assert judge.truth_rows(dec, truth) == lone and int(stats.n_slot_single) == 0


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


def test_run_and_control_hand_the_rule_to_the_reference(tmp_path):
    """A whole run and the control's readings judge the program by the
    configuration's rule: the port, which still calls each lone Miller slot
    a collision, now differs from the reference in every such slot."""
    from rfidbench.control import readings
    from rfidbench.run import run

    add_config(tmp_path, "miller4_blf40_2msps", "miller4_band", MILLER_BAND)
    cell = cell_of(tmp_path, "miller4_band")
    checks = run(cell, 2 ** 31 + 3, 0.3, False, torch.device("cpu"))["checks"]
    assert checks["decode_rows"]["value"] == checks["truth_rows"]["value"] == 6
    assert checks["stats_fields"]["value"] == 2 and checks["event_rows"]["value"] == 0
    ((_, prog, _),) = readings(cell, [2 ** 31 + 3], torch.device("cpu"))
    assert prog["decode_rows"]["value"] == 6


def test_slot_bands_table(capsys):
    """``python -m rfidbench.slot_bands`` at one noise and seed: a row for
    each link and tag set, and no collided window that a rule fitted to the
    lone ones would call single."""
    from rfidbench.slot_bands import LINKS, PHASES, main

    assert main(["--noises", "0.004", "--seeds", "3"]) == 0
    rows = capsys.readouterr().out.splitlines()[2:]
    assert len(rows) == len(LINKS) * len(PHASES)
    assert all(r.split("|")[7].strip() == "0" for r in rows), rows
