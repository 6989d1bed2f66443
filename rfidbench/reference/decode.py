"""The reference's event decode, EPC check and round replay, and its
whole-capture entry ``decode_capture``.

Each event is decoded on its own, as the reply window its command opens: a
Query, QueryRep or QueryAdjust an RN16 window, an ACK an EPC window.  The
EPC's CRC is the Gen2 CRC-16 stepped bit by bit.  The round replay walks
the events in order on the host."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import detect
from .front import GRANULE, Events, above_threshold, front_taps, front_y, gate_events

_I32 = torch.int32
_F64 = torch.float64
N_TAG_BINS = 256
BLOCK = 1024                # events decoded together
CMD_QUERY, CMD_QREP, CMD_ACK, CMD_QADJ, CMD_NAK, CMD_UNKNOWN = 0, 1, 2, 3, 4, 5


class Decoded(NamedTuple):
    """Per-event results, the fields of the port's ``DecodedEvents``."""

    index: torch.Tensor
    valid: torch.Tensor
    rn16_fits: torch.Tensor
    epc_fits: torch.Tensor
    rn16_bits: torch.Tensor
    epc_bits: torch.Tensor
    epc_pass: torch.Tensor
    tag_id: torch.Tensor
    t_half: torch.Tensor
    h_est: torch.Tensor
    slot_state: torch.Tensor
    rn16_energy: torch.Tensor
    rn16_margin: torch.Tensor
    cmd_type: torch.Tensor


class Stats(NamedTuple):
    """The fields of the port's ``InventoryStats``."""

    n_queries: torch.Tensor
    cur_inventory_round: torch.Tensor
    cur_slot: torch.Tensor
    n_epc_correct: torch.Tensor
    tag_reads: torch.Tensor
    unique_tags_round: torch.Tensor
    n_rounds_closed: torch.Tensor
    n_events: torch.Tensor
    terminated: torch.Tensor
    n_slot_empty: torch.Tensor
    n_slot_single: torch.Tensor
    n_slot_collision: torch.Tensor
    cmd_counts: torch.Tensor


def check_supported(cfg) -> None:
    """The reference decodes native mode without CW cancellation, channel
    tracking or soft EPC recovery; any other configuration is refused."""
    off = {"mode": cfg.mode != "native", "cancel_cw": bool(cfg.cancel_cw),
           "track_channel": bool(cfg.track_channel), "epc_softfix": bool(cfg.epc_softfix)}
    bad = [k for k, v in off.items() if v]
    if bad:
        raise ValueError(f"the reference does not decode with {bad}")


def command_pulses(cfg) -> np.ndarray:
    """PIE pulses (rises) of each command, by command type: a Query's
    preamble has four (delimiter, data-0, RTcal, TRcal), the others' frame
    sync three, and each bit one more.  Query: its bits; QueryRep: 4;
    ACK: 2 + the RN16's 16; QueryAdjust: 9; NAK: 8."""
    return np.array([4 + cfg.query_length, 3 + 4, 3 + 2 + 16, 3 + 9, 3 + 8])


def command_type(n_pulses: int, expected: np.ndarray) -> int:
    """The command whose pulse count is nearest, if within one pulse and no
    other is as near; else unknown."""
    dist = np.abs(int(n_pulses) - expected)
    best = int(np.argmin(dist))
    if dist[best] <= 1 and np.sum(dist == dist[best]) == 1:
        return best
    return CMD_UNKNOWN


def crc16(bits: np.ndarray) -> np.ndarray:
    """(F, n) bits -> (F, n + 1, 16): the Gen2 CRC-16 (x^16 + x^12 + x^5 +
    1, preset 0xFFFF, sent inverted, first bit first) of each prefix of
    each row, as the bits it sends."""
    f, n = bits.shape
    reg = np.full(f, 0xFFFF, dtype=np.int64)
    out = np.zeros((f, n + 1), dtype=np.int64)
    out[:, 0] = reg
    for i in range(n):
        fb = ((reg >> 15) & 1) ^ bits[:, i]
        reg = ((reg << 1) & 0xFFFF) ^ (fb * 0x1021)
        out[:, i + 1] = reg
    sent = ~out & 0xFFFF
    return (sent[:, :, None] >> np.arange(15, -1, -1)) & 1


def check_epc(frames: np.ndarray):
    """(CRC pass, tag id) of each (F, 128) PC + EPC + CRC frame: the PC's
    first five bits give the EPC's length in words, the CRC-16 over the PC
    and that EPC has to be the 16 bits after them, and the tag id is the
    EPC's last byte (at the longest length the frame holds, where the PC
    asks for more)."""
    f, n = frames.shape
    l_max = (n - 32) // 16
    words = frames[:, :5] @ (1 << np.arange(4, -1, -1))
    length = 16 + 16 * np.minimum(words, l_max)
    crcs = crc16(frames[:, : 16 + 16 * l_max])
    rows = np.arange(f)
    sent = frames[rows[:, None], length[:, None] + np.arange(16)[None, :]]
    ok = (words <= l_max) & np.all(crcs[rows, length] == sent, axis=1)
    tid = frames[rows[:, None], length[:, None] - 8 + np.arange(8)[None, :]] @ (
        1 << np.arange(7, -1, -1))
    return ok, tid


# An RN16 window is empty where its power is under this many times the
# noise's, at every link.
EMPTY_FACTOR = 4.0


class SlotRule(NamedTuple):
    """The thresholds of the slot verdict, a configuration's ``slot_rule``.
    The defaults are the rule fitted to FM0, which the port's
    ``classify_slots`` applies at every link."""

    margin_min: float = 0.68
    excess: Tuple[float, float] = (0.0, 0.42)


def slot_state(energy, margin, noise_var, h, rule: SlotRule = SlotRule()):
    """Empty (0) where the RN16 window's power is under ``EMPTY_FACTOR``
    times the noise; else a collision (2) where the margin is under
    ``margin_min`` or the power lies outside ``excess`` times |h|^2; else
    single (1).  Each threshold is multiplied out, never divided into the
    power: a power exactly at a threshold keeps the verdict the FM0
    constants gave it."""
    occupied = energy >= EMPTY_FACTOR * noise_var
    h2 = torch.clamp(h.abs() ** 2, min=1e-12)
    collision = ((margin < rule.margin_min) | (energy > rule.excess[1] * h2)
                 | (energy < rule.excess[0] * h2))
    return torch.where(occupied, torch.where(collision, 2, 1), 0)


def windows(y: torch.Tensor, ev: Events, rows: torch.Tensor, width: int) -> torch.Tensor:
    """Reply windows of the events ``rows``: ``width + GRANULE`` samples of
    y from the event rounded down to a GRANULE (samples past the capture's
    last GRANULE read its last GRANULE again), less the event's DC."""
    n = y.shape[0]
    g = GRANULE
    last = -(-n // g) - 1
    yp = torch.cat([y, y.new_zeros((last + 1) * g - n)])
    a = (torch.clamp(ev.index[rows].to(torch.int64), max=n - 1) // g) * g
    p = a[:, None] + torch.arange(width + g, device=y.device)[None, :]
    p = torch.clamp(p // g, max=last) * g + p % g
    return yp[p] - ev.dc[rows][:, None]


def _decode_rn16(frames, cfg):
    if cfg.miller_m == 1:
        index, h = detect.fm0_sync(frames, cfg)
        bits, margin = detect.fm0_rn16(frames, index, h, cfg)
    else:
        index, h, eps = detect.miller_sync(frames, cfg)
        bits, _, margin = detect.miller_detect(frames, index, h, cfg, 16, eps)
    return bits, margin, h


def _decode_epc(frames, cfg):
    if cfg.miller_m == 1:
        index, h = detect.fm0_sync(frames, cfg)
        bits, t_half = detect.fm0_epc(frames, index, h, cfg)
    else:
        index, h, eps = detect.miller_sync(frames, cfg)
        bits, t_half, _ = detect.miller_detect(frames, index, h, cfg, cfg.epc_data_bits, eps)
    return bits, t_half, h


def decode_events(y: torch.Tensor, ev: Events, cfg, slot_rule: SlotRule = SlotRule()
                  ) -> Decoded:
    """Every valid event decoded as the window its command opens, each RN16
    window's slot by ``slot_rule``.  Fields a row's command does not open
    are 0 (``slot_state`` -1)."""
    n = y.shape[0]
    cap = ev.index.shape[0]
    dev = y.device
    expected = command_pulses(cfg)
    valid_np = ev.valid.cpu().numpy()
    cmd_np = np.array([command_type(p, expected) if v else CMD_UNKNOWN
                       for p, v in zip(ev.n_pulses.cpu().numpy(), valid_np)], dtype=np.int32)
    cmd = torch.as_tensor(cmd_np, device=dev)
    out = {"rn16_bits": torch.zeros((cap, 16), dtype=_I32, device=dev),
           "epc_bits": torch.zeros((cap, cfg.epc_data_bits), dtype=_I32, device=dev),
           "epc_pass": torch.zeros(cap, dtype=torch.bool, device=dev),
           "tag_id": torch.zeros(cap, dtype=_I32, device=dev),
           "t_half": torch.zeros(cap, dtype=_F64, device=dev),
           "h_est": torch.zeros(cap, dtype=y.dtype, device=dev),
           "slot_state": torch.full((cap,), -1, dtype=_I32, device=dev),
           "rn16_energy": torch.zeros(cap, dtype=_F64, device=dev),
           "rn16_margin": torch.zeros(cap, dtype=_F64, device=dev)}
    q_rows = np.flatnonzero(valid_np & np.isin(cmd_np, (CMD_QUERY, CMD_QREP, CMD_QADJ)))
    a_rows = np.flatnonzero(valid_np & (cmd_np == CMD_ACK))
    for b in range(0, q_rows.size, BLOCK):
        r = torch.as_tensor(q_rows[b: b + BLOCK], device=dev)
        fr = windows(y, ev, r, cfg.rn16_window)
        bits, margin, h = _decode_rn16(fr, cfg)
        energy = (fr.real ** 2 + fr.imag ** 2).mean(dim=1)
        out["rn16_bits"][r] = bits
        out["rn16_margin"][r] = margin
        out["rn16_energy"][r] = energy
        out["h_est"][r] = h
        out["slot_state"][r] = slot_state(energy, margin, ev.noise_var[r], h,
                                        slot_rule).to(_I32)
    for b in range(0, a_rows.size, BLOCK):
        r = torch.as_tensor(a_rows[b: b + BLOCK], device=dev)
        bits, t_half, h = _decode_epc(windows(y, ev, r, cfg.epc_window), cfg)
        ok, tid = check_epc(bits.cpu().numpy().astype(np.int64))
        out["epc_bits"][r] = bits
        out["epc_pass"][r] = torch.as_tensor(ok, device=dev)
        out["tag_id"][r] = torch.as_tensor(tid, dtype=_I32, device=dev)
        out["t_half"][r] = t_half
        out["h_est"][r] = h
    h = out.pop("h_est")
    return Decoded(index=ev.index, valid=ev.valid,
                   rn16_fits=ev.valid & (ev.index + cfg.rn16_window <= n),
                   epc_fits=ev.valid & (ev.index + cfg.epc_window <= n),
                   h_est=torch.stack([h.real, h.imag], dim=-1), cmd_type=cmd, **out)


def replay(dec: Decoded, cfg) -> Stats:
    """The Gen2 round FSM walked event by event on the host: a processed
    Query-like event counts a query and its slot state, a processed ACK an
    EPC read where its CRC passes and closes the slot; an event inside the
    last processed window, one whose window runs past the capture, one of
    unknown type, and every event once the query or unique-tag limit is
    passed, are not processed."""
    idx, valid, rn_fit, epc_fit, ok, tid, sstate, ctype = (
        t.cpu().numpy() for t in (dec.index, dec.valid, dec.rn16_fits, dec.epc_fits,
                                  dec.epc_pass, dec.tag_id, dec.slot_state, dec.cmd_type))
    e = idx.shape[0]
    max_slot = cfg.max_slot_number
    ptr, slot, rnd, n_q, n_ok, n_uni, n_rounds = 0, 1, 1, 0, 0, 0, 0
    term = False
    reads = np.zeros(N_TAG_BINS, np.int32)
    uni_hist = np.zeros(e, np.int32)
    slot_counts = np.zeros(3, np.int32)
    cmd_counts = np.zeros(6, np.int32)
    for k in range(e):
        term = term or n_q > cfg.max_num_queries or n_uni > cfg.max_unique_tags
        c = int(ctype[k])
        qlike = c in (CMD_QUERY, CMD_QREP, CMD_QADJ)
        is_ack = c == CMD_ACK
        live = bool(valid[k]) and not term and int(idx[k]) >= ptr
        fits = bool(epc_fit[k]) if is_ack else bool(rn_fit[k])
        proc = live and (qlike or is_ack) and fits
        if not proc:
            continue
        cmd_counts[c] += 1
        if qlike:
            n_q += 1
            slot_counts[min(max(int(sstate[k]), 0), 2)] += 1
            ptr = int(idx[k]) + cfg.rn16_window
            continue
        if ok[k]:
            t = int(tid[k])
            if reads[t] == 0:
                n_uni += 1
            reads[t] += 1
            n_ok += 1
        slot += 1
        if slot > max_slot:
            uni_hist[min(n_rounds, e - 1)] = n_uni
            n_rounds += 1
            rnd += 1
            slot = 1
        ptr = int(idx[k]) + cfg.epc_window
    dev = dec.index.device

    def t(v, dtype=_I32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    return Stats(
        n_queries=t(n_q), cur_inventory_round=t(rnd), cur_slot=t(slot),
        n_epc_correct=t(n_ok), tag_reads=t(reads), unique_tags_round=t(uni_hist),
        n_rounds_closed=t(n_rounds), n_events=dec.valid.sum(dtype=_I32),
        terminated=t(term, torch.bool), n_slot_empty=t(slot_counts[0]),
        n_slot_single=t(slot_counts[1]), n_slot_collision=t(slot_counts[2]),
        cmd_counts=t(cmd_counts))


def decode_capture(x2: torch.Tensor, cfg, front_dtype: torch.dtype = _F64,
                   slot_rule: SlotRule = SlotRule()):
    """(Stats, Decoded) of a planar (2, N) float32 ADC-rate capture, on the
    capture's device, its slots by ``slot_rule`` (the configuration's).
    ``front_dtype=torch.bfloat16`` is the control."""
    check_supported(cfg)
    y = front_y(x2, cfg.decim, front_taps(cfg), front_dtype)
    ev = gate_events(y, cfg, above_threshold(y, cfg.win_length, cfg.thresh_fraction))
    dec = decode_events(y, ev, cfg, slot_rule)
    return replay(dec, cfg), dec
