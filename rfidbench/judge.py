"""How ``correct`` is decided: the program's outputs beside the reference's
and beside what the synthesizer sent.

Each run keeps, for every capture it decodes in turn, the outputs of that
capture's last decode in the window, and holds them against two
witnesses: the plain reference decode of the same capture
(``rfidbench/reference``), and the ground truth of the synthesizer that
made it (the commands it sent, the tags' replies):

* ``event_rows``: event rows whose ``valid`` differs from the reference's,
  or that are valid with another ``index`` or ``cmd_type``; limit 0.
* ``decode_rows``: the reference's valid rows whose window fits, decoded
  bits, CRC verdict, tag id or slot state differ; limit 0.
* ``stats_fields``: ``InventoryStats`` fields that differ from the
  reference's replay of its own decode; limit 0.
* ``float_gap``: the widest gap of the float fields (``t_half``, ``h_est``,
  ``rn16_energy``, ``rn16_margin``), each field's largest |program -
  reference| over the median |reference| of its nonzero entries; limit the
  workload file's ``limits.float_gap``.
* ``truth_rows``: commands the synthesizer sent that the event table does
  not hold once, ``Truth.delay`` after the command ends, with the
  command's type and, where one tag replied alone, its RN16 or its EPC frame, a passing CRC,
  its tag id and a single slot (an empty or collided slot where none or
  several replied), plus valid events that match no command; limit 0.
* ``epc_misses``: decodes of the window whose EPC count is not the count
  the synthesizer sent; limit 0.

Each check is the worst over the captures.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

FLOAT_FIELDS = ("t_half", "h_est", "rn16_energy", "rn16_margin")
DECODE_FIELDS = ("rn16_fits", "epc_fits", "rn16_bits", "epc_bits", "epc_pass", "tag_id",
                 "slot_state")
STATS_FIELDS = ("n_queries", "cur_inventory_round", "cur_slot", "n_epc_correct", "tag_reads",
                "unique_tags_round", "n_rounds_closed", "n_events", "terminated",
                "n_slot_empty", "n_slot_single", "n_slot_collision", "cmd_counts")
CHECKS = ("event_rows", "decode_rows", "stats_fields", "float_gap", "truth_rows")
KIND_CMD = {"query": 0, "query_rep": 1, "ack": 2}


class Truth(NamedTuple):
    """What the synthesizer sent: one inventory's commands, tiled."""

    events: list           # the synthesizer's TraceEvents of one tile
    tile: int              # ADC samples a tile
    tiles: int
    decim: int
    slack: int             # y samples either side of the expected event
    delay: float           # y samples from a command's end to its event


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _row_diff(a, b) -> np.ndarray:
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        return np.ones(max(a.shape[:1] + b.shape[:1]), dtype=bool)
    return (a != b).reshape(a.shape[0], -1).any(axis=1)


def event_rows(got, want) -> int:
    gv, wv = _np(got.valid), _np(want.valid)
    if gv.shape != wv.shape:
        return int(max(gv.size, wv.size))
    d = (gv != wv) | (wv & (_row_diff(got.index, want.index) | _row_diff(got.cmd_type,
                                                                          want.cmd_type)))
    return int(d.sum())


def decode_rows(got, want) -> int:
    wv = _np(want.valid)
    d = np.zeros_like(wv)
    for f in DECODE_FIELDS:
        diff = _row_diff(getattr(got, f), getattr(want, f))
        if diff.shape != wv.shape:
            return int(wv.size)
        d |= diff
    return int((d & wv).sum())


def float_gap(got, want) -> float:
    worst = 0.0
    for f in FLOAT_FIELDS:
        a, b = getattr(got, f).cpu().double(), getattr(want, f).cpu().double()
        if a.shape != b.shape:
            return float("inf")
        scale = b[b != 0].abs()
        if not scale.numel():
            continue
        gap = float((a - b).abs().max() / scale.median())
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def sent_rows(dec, truth: Truth):
    """(found, rows): for each command the synthesizer sent, whether the
    table holds exactly one valid event within ``truth.slack`` of
    ``truth.delay`` after the command ends, and that event's row (the first
    valid row where none is found)."""
    valid = _np(dec.valid)
    index = _np(dec.index).astype(np.int64)[valid]
    at = (np.arange(truth.tiles)[:, None] * truth.tile
          + np.array([e.cmd_end for e in truth.events])) / truth.decim + truth.delay
    lo = np.searchsorted(index, at - truth.slack, side="left")
    found = np.searchsorted(index, at + truth.slack, side="left") - lo == 1
    return found, np.flatnonzero(valid)[np.where(found, lo, 0)]


def truth_rows(dec, truth: Truth) -> int:
    """Commands sent that the table does not hold as sent, plus valid events
    that match no command sent."""
    from .synth.sim.tag import tag_id_of_frame

    valid = _np(dec.valid)
    evs = truth.events
    single = np.array([e.reply_tag is not None and e.reply_bits is not None for e in evs])
    ack = np.array([e.kind == "ack" for e in evs])
    n_bits = (dec.rn16_bits.shape[1], dec.epc_bits.shape[1])
    sent = np.zeros((len(evs), max(n_bits)), dtype=np.int64)
    for i, e in enumerate(evs):
        if single[i]:
            sent[i, : len(e.reply_bits)] = e.reply_bits
    tid = np.array([tag_id_of_frame(e.reply_bits) if s and a else -1
                    for e, s, a in zip(evs, single, ack)])
    state = np.where(single, 1, np.where([e.collided for e in evs], 2, 0))
    found, rows = sent_rows(dec, truth)
    got = {f: _np(getattr(dec, f))[rows] for f in ("cmd_type", "rn16_bits", "epc_bits",
                                                   "epc_pass", "tag_id", "slot_state")}
    cmd_ok = got["cmd_type"] == np.array([KIND_CMD[e.kind] for e in evs])
    rn16_ok = np.all(got["rn16_bits"] == sent[:, : n_bits[0]], axis=-1) | ~single
    epc_ok = np.all(got["epc_bits"] == sent[:, : n_bits[1]], axis=-1)
    ack_ok = np.where(single, epc_ok & got["epc_pass"] & (got["tag_id"] == tid),
                      ~got["epc_pass"])
    reply_ok = np.where(ack, ack_ok, (got["slot_state"] == state) & rn16_ok)
    used = np.zeros(valid.size, dtype=bool)
    used[rows[found]] = True
    return int((~(found & cmd_ok & reply_ok)).sum() + (valid & ~used).sum())


def compare(got_stats, got_dec, want_stats, want_dec, truth: Optional[Truth] = None
            ) -> Dict[str, float]:
    """The output checks of one capture."""
    stats = sum(not torch.equal(getattr(got_stats, f).cpu(), getattr(want_stats, f).cpu())
                for f in STATS_FIELDS)
    out = {"event_rows": event_rows(got_dec, want_dec),
           "decode_rows": decode_rows(got_dec, want_dec),
           "stats_fields": int(stats),
           "float_gap": float_gap(got_dec, want_dec)}
    if truth is not None:
        out["truth_rows"] = truth_rows(got_dec, truth)
    return out


def checks(per_capture: List[Dict[str, float]], epc_misses: int, limits: dict) -> Dict:
    """{check: {"value", "limit"}}: the worst over the captures."""
    out = {}
    for name in CHECKS:
        if name in per_capture[0]:
            out[name] = {"value": max(c[name] for c in per_capture),
                         "limit": limits.get(name, 0)}
    out["epc_misses"] = {"value": epc_misses, "limit": 0}
    return out


def passed(result: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in result.values())
