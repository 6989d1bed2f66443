"""Batch inventory decode: full pipeline + explicit round-FSM replay.

PyTorch counterpart of ``gen2_rfid_tpu/runtime/inventory.py`` for FM0 and
Miller-M (dsp/miller.py), in native and compat mode.  Every heavy stage
(front end, gate, window extraction, sync, RN16/EPC detection, CRC) runs
batched over all events at once; the Gen2 inventory-round state machine is
then replayed over the event table, in closed form for well-formed tables
and with the exact sequential scan otherwise.  ``decode_events_multi`` and
``replay_inventory_batch`` do the same for several channels' tables at
once.

``decode_capture_planar`` runs one pipeline on either device, after the
optional CW cancellation (dsp/interference.py).  The front end
(kernels/gate_front.py) gives y; then

* native mode: the front end's y build gives y alone, the gate-stack kernel
  (kernels/gate_stack.py) packs the gate flags of y, ``gate_detect`` reads
  them, and ``decode_events`` decodes each event's role-specialized window;
* compat mode: the front end's full build gives y, |y| and the windowed |y|
  sum, ``gate_detect`` reads |y| and the average, and ``decode_events``
  decodes every event as both windows;
* ``exact_gate=True``, either mode: the full build, then
  ``gate_detect_scan`` walks the reference FSM over the same |y| and
  average (kernels/gate_scan.py).

``replay_inventory`` follows.  On CUDA tensors the kernels launch; on CPU
tensors their plain versions run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..dsp import fm0, miller, sync
from ..dsp.filters import boxcar_taps
from ..dsp.gate import GateEvents, front_end, gate_detect, gate_detect_scan
from ..dsp.interference import cancel_cw_planar
from ..kernels.gate_front import front_taps
from ..protocol.crc import crc16_affine
from ..utils import profiling
from .frames import extract_windows, gather_aligned_windows_multi
from .softfix import recover_epc_batch
from .stats import N_TAG_BINS, InventoryStats


class DecodedEvents(NamedTuple):
    """Per-event decode results (fixed capacity, mask-validated)."""

    index: torch.Tensor       # (E,) int32
    valid: torch.Tensor       # (E,) bool
    rn16_fits: torch.Tensor   # (E,) bool
    epc_fits: torch.Tensor    # (E,) bool
    rn16_bits: torch.Tensor   # (E, 16) int32
    epc_bits: torch.Tensor    # (E, 128) int32
    epc_pass: torch.Tensor    # (E,) bool CRC verdict
    tag_id: torch.Tensor      # (E,) int32
    t_half: torch.Tensor      # (E,) float32 estimated half period
    h_est: torch.Tensor       # (E, 2) float32 channel estimate (re, im)
    slot_state: torch.Tensor  # (E,) int32: 0 empty / 1 single / 2 collision
    rn16_energy: torch.Tensor  # (E,) float32 mean |window|^2 over the RN16 window
    rn16_margin: torch.Tensor  # (E,) float32 FM0 decision margin
    cmd_type: torch.Tensor    # (E,) int32 classified command (CMD_*)


SLOT_EMPTY, SLOT_SINGLE, SLOT_COLLISION = 0, 1, 2
CMD_QUERY, CMD_QREP, CMD_ACK, CMD_QADJ, CMD_NAK, CMD_UNKNOWN = 0, 1, 2, 3, 4, 5
ROLE_SLACK = 16  # extra per-role capacity absorbing event-table anomalies
# Index past every real event: the closed-form replay's "no next event".
# Invalid table slots carry index n instead, and are never processed.
NO_NEXT_EVENT = 1 << 30

_I32 = torch.int32


def expected_pulse_counts(cfg: ReaderConfig) -> np.ndarray:
    """PIE pulse count per command type (order: CMD_QUERY..CMD_NAK): one rise
    per bit plus 4 preamble rises for Query and 3 frame-sync rises for the
    rest (reader_impl.cc:98-128)."""
    return np.array(
        [4 + cfg.query_length,            # Query: preamble + 22 bits
         3 + 4,                            # QueryRep: frame-sync + 4 bits
         3 + 2 + 16,                       # ACK: frame-sync + 18 bits
         3 + 9,                            # QueryAdjust: frame-sync + 9 bits
         3 + 8],                           # NAK: frame-sync + 8 bits
        dtype=np.int32,
    )


@functools.lru_cache(maxsize=32)
def _pulse_counts_device(cfg: ReaderConfig, device: torch.device) -> torch.Tensor:
    """``expected_pulse_counts`` on a device, kept for the next decode."""
    return profiling.to_device(expected_pulse_counts(cfg), device)


def classify_commands(n_pulses: torch.Tensor, cfg: ReaderConfig) -> torch.Tensor:
    """Command type per event from its pulse count: within +-1 of a unique
    expected count, else CMD_UNKNOWN (inventory.py:90-106)."""
    table = _pulse_counts_device(cfg, n_pulses.device)
    diff = (n_pulses[:, None] - table[None, :]).abs()
    best = torch.argmin(diff, dim=1).to(_I32)
    dmin = diff.min(dim=1).values
    second = torch.sort(diff, dim=1).values[:, 1]
    ok = (dmin <= 1) & (second > dmin)
    return torch.where(ok, best, CMD_UNKNOWN).to(_I32)


def command_roles(cmd_type: torch.Tensor, valid: torch.Tensor):
    """(RN16-window role, EPC-window role) per event from its command:
    Query/QueryRep/QueryAdjust open an RN16 window, ACK an EPC window."""
    qlike = (cmd_type == CMD_QUERY) | (cmd_type == CMD_QREP) | (cmd_type == CMD_QADJ)
    return valid & qlike, valid & (cmd_type == CMD_ACK)


def classify_slots(energy, margin, noise_var, h2, energy_factor: float = 4.0,
                   margin_thresh: float = 0.68, excess_factor: float = 0.42):
    """Slot state of RN16 reply windows: empty / single / collision
    (inventory.py:128-155)."""
    occupied = energy >= energy_factor * noise_var
    collision = (margin < margin_thresh) | (
        energy > excess_factor * torch.clamp(h2, min=1e-12))
    return torch.where(occupied, torch.where(collision, SLOT_COLLISION, SLOT_SINGLE),
                       SLOT_EMPTY).to(_I32)


def _gf2_product(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """bits (E, K) 0/1 @ m (K, C) 0/1 float32 as exact integer counts.  The
    product runs in float32 (CUDA has no integer matmul): every term is 0 or
    1 and every sum is at most K, exact in float32 even with TF32 inputs."""
    return torch.matmul(bits.to(torch.float32), m).round().to(_I32)


@functools.lru_cache(maxsize=32)
def _bit_weights(n: int, device: torch.device) -> torch.Tensor:
    """(n,) int64 weights 2**(n-1) .. 1 of an MSB-first bit field, on a
    device, kept for the next decode."""
    return profiling.to_device(2 ** np.arange(n - 1, -1, -1), device)


@functools.lru_cache(maxsize=8)
def _crc_fixed_device(n_data: int, device: torch.device):
    """The fixed-length CRC's (M^T float32, c0 int32) on a device, kept for
    the next decode."""
    m, c0 = crc16_affine(n_data)
    return (profiling.to_device(m.T, device, torch.float32),
            profiling.to_device(c0.astype(np.int32), device))


def check_epc_crc_batch(epc_bits: torch.Tensor) -> torch.Tensor:
    """Fixed-length CRC-16 check of (E, n_bits) frames -> (E,) bool."""
    n_data = epc_bits.shape[1] - 16
    mt, c0 = _crc_fixed_device(n_data, epc_bits.device)
    crc = (_gf2_product(epc_bits[:, :n_data], mt) % 2) ^ c0[None, :]
    return torch.all(crc == epc_bits[:, n_data:], dim=1)


@functools.lru_cache(maxsize=8)
def _pc_length_tables(n_bits: int):
    """Tables for PC-length-aware EPC validation (inventory.py:173-205):
    M, R (n_bits, (l_max+1)*16), ID (n_bits, (l_max+1)*8), c0, l_max."""
    l_max = (n_bits - 32) // 16
    m_all = np.zeros((n_bits, (l_max + 1) * 16), dtype=np.int32)
    c0_all = np.zeros(((l_max + 1) * 16,), dtype=np.int32)
    r_all = np.zeros((n_bits, (l_max + 1) * 16), dtype=np.int32)
    id_all = np.zeros((n_bits, (l_max + 1) * 8), dtype=np.int32)
    for l in range(l_max + 1):
        dl = 16 + 16 * l
        m, c0 = crc16_affine(dl)
        m_all[:dl, 16 * l: 16 * l + 16] = m.T
        c0_all[16 * l: 16 * l + 16] = c0
        r_all[np.arange(dl, dl + 16), 16 * l + np.arange(16)] = 1
        id_all[np.arange(dl - 8, dl), 8 * l + np.arange(8)] = 1
    return m_all, c0_all, r_all, id_all, l_max


@functools.lru_cache(maxsize=8)
def _pc_length_device(n_bits: int, device: torch.device):
    """``_pc_length_tables`` on a device, kept for the next decode: M, R and
    ID float32 for ``_gf2_product``, c0 int32, and l_max."""
    m_all, c0_all, r_all, id_all, l_max = _pc_length_tables(n_bits)

    def f32(a):
        return profiling.to_device(a, device, torch.float32)

    return f32(m_all), profiling.to_device(c0_all, device), f32(r_all), f32(id_all), l_max


def check_epc_crc_pc(epc_bits: torch.Tensor):
    """PC-length-aware validation: (pass (E,) bool, tag_id (E,) int32,
    epc_words (E,) int32) (inventory.py:208-234)."""
    dev = epc_bits.device
    m_all, c0_all, r_all, id_all, l_max = _pc_length_device(epc_bits.shape[1], dev)
    crc_all = (_gf2_product(epc_bits, m_all) % 2) ^ c0_all
    rec_all = _gf2_product(epc_bits, r_all)
    match = torch.all((crc_all == rec_all).reshape(-1, l_max + 1, 16), dim=2)
    ids = _gf2_product(epc_bits, id_all).reshape(-1, l_max + 1, 8)
    l_parsed = (epc_bits[:, :5].to(torch.int64) * _bit_weights(5, dev)).sum(dim=1)
    lc = torch.clamp(l_parsed, 0, l_max)
    ok = match.gather(1, lc[:, None])[:, 0] & (l_parsed <= l_max)
    tid = (ids[torch.arange(ids.shape[0], device=dev), lc].to(torch.int64)
           * _bit_weights(8, dev)).sum(dim=1)
    return ok, tid.to(_I32), l_parsed.to(_I32)


def _tag_ids(epc_bits: torch.Tensor) -> torch.Tensor:
    """Reference tag id: EPC frame bits[104:112] as an integer."""
    w8 = _bit_weights(8, epc_bits.device)
    return (epc_bits[:, 104:112].to(torch.int64) * w8).sum(dim=1).to(_I32)


def _validate_epc(epc_bits: torch.Tensor, cfg: ReaderConfig):
    """(pass, tag_id): compat's fixed 96-bit check and bits[104:112] id, or
    native's PC-length-aware check."""
    if cfg.mode == "compat":
        return check_epc_crc_batch(epc_bits), _tag_ids(epc_bits)
    ok, tid, _ = check_epc_crc_pc(epc_bits)
    return ok, tid


def _validate_epc_soft(epc_bits: torch.Tensor, rel: torch.Tensor, cfg: ReaderConfig):
    """(pass, tag_id, epc_bits) with CRC-guided recovery of failed frames
    when ``cfg.epc_softfix`` is set (inventory.py:247-264): recovered frames
    carry their repaired bits.  Compat never recovers (the reference
    discards CRC failures)."""
    ok, tid = _validate_epc(epc_bits, cfg)
    if not cfg.epc_softfix or cfg.mode == "compat":
        return ok, tid, epc_bits
    fixed_bits, fixed = recover_epc_batch(
        epc_bits, rel, cfg, lambda b: _validate_epc(b, cfg))
    merged = torch.where((fixed & ~ok)[:, None], fixed_bits, epc_bits)
    ok2, tid2 = _validate_epc(merged, cfg)
    return ok2, tid2, merged


def _sync(frames, cfg):
    """(index, h_est, eps): FM0's preamble sync (eps None) or Miller's, whose
    chip-period estimate seeds the segment cascade (inventory.py:267-332)."""
    if cfg.miller_m == 1:
        return sync.tag_sync(frames, cfg) + (None,)
    return miller.miller_sync_full(frames, cfg)


def _detect_rn16(frames, index, h_est, eps, cfg):
    """(bits, margin) of the RN16, FM0 or Miller."""
    if cfg.miller_m == 1:
        return fm0.rn16_detect_soft(frames, index, h_est, cfg)
    return miller.miller_rn16_soft(frames, index, h_est, cfg, eps0=eps)


def _decode_rn16_frames(frames, cfg):
    index, h_est, eps = _sync(frames, cfg)
    bits, margin = _detect_rn16(frames, index, h_est, eps, cfg)
    return bits, h_est, margin


def _detect_epc(frames, magn2, index, h_est, eps, cfg):
    """(bits, t_half, rel): FM0's period estimate and half-period, or the
    Miller cascade and its chip period; rel the per-bit reliabilities."""
    if cfg.miller_m == 1:
        return fm0.epc_detect_soft(frames, magn2, index, h_est, cfg)
    return miller.miller_epc_soft(frames, index, h_est, cfg, eps0=eps)


def _decode_epc_frames(frames, magn2, cfg):
    index, h_est, eps = _sync(frames, cfg)
    bits, t_half, rel = _detect_epc(frames, magn2, index, h_est, eps, cfg)
    return bits, t_half, h_est, rel


def _h_planes(h: torch.Tensor) -> torch.Tensor:
    return torch.stack([h.real, h.imag], dim=-1)


def _decode_events_paranoid(y, events: GateEvents, cmd, cfg) -> DecodedEvents:
    """Role-agnostic decode: every event as both an RN16 and an EPC window,
    one sync for both."""
    frames, magn2, rn16_fits, epc_fits = extract_windows(y, events, cfg)
    index, h_est, eps = _sync(frames, cfg)
    rn16_bits, margin = _detect_rn16(frames, index, h_est, eps, cfg)
    epc_bits, t_half, rel = _detect_epc(frames, magn2, index, h_est, eps, cfg)
    epc_pass, tag_id, epc_bits = _validate_epc_soft(epc_bits, rel, cfg)
    energy = magn2[:, : cfg.rn16_window].mean(dim=1)
    h2 = h_est.real ** 2 + h_est.imag ** 2
    return DecodedEvents(
        index=events.index, valid=events.valid, rn16_fits=rn16_fits,
        epc_fits=epc_fits, rn16_bits=rn16_bits, epc_bits=epc_bits,
        epc_pass=epc_pass, tag_id=tag_id, t_half=t_half, h_est=_h_planes(h_est),
        slot_state=classify_slots(energy, margin, events.noise_var, h2),
        rn16_energy=energy, rn16_margin=margin, cmd_type=cmd,
    )


def _decode_events_queued(y: torch.Tensor, events: GateEvents, cfg: ReaderConfig,
                          specialize: bool):
    """(decoded events, overflow): ``decode_events`` queued with no read.
    ``overflow`` is a 0-d device flag, whether either role holds more events
    than the specialized decode's per-role tables, or None where the
    paranoid decode ran or the tables hold the whole capacity."""
    cmd = classify_commands(events.n_pulses, cfg)
    if not specialize:
        return _decode_events_paranoid(y, events, cmd, cfg), None
    cap = events.index.shape[0]
    cap_q = min(cap, cap // 2 + 1 + ROLE_SLACK)
    role_q, role_a = command_roles(cmd, events.valid)
    overflow = None
    if cap_q != cap:
        overflow = (role_q.sum() > cap_q) | (role_a.sum() > cap_q)
    dec = _decode_specialized(y[None], GateEvents(*(t[None] for t in events)), cmd[None],
                              role_q[None], role_a[None], cap_q, cfg)
    return DecodedEvents(*(t[0] for t in dec)), overflow


@profiling.spanned("gen2.decode_events")
def decode_events(y: torch.Tensor, events: GateEvents, cfg: ReaderConfig,
                  specialize: bool = False, overflow_fallback: bool = True
                  ) -> DecodedEvents:
    """Batched per-event decode (sync + RN16 + EPC + CRC).

    ``specialize=False`` (paranoid) decodes every event as both windows;
    ``specialize=True`` decodes only the window its classified command opens,
    over per-role tables of half the capacity plus ``ROLE_SLACK``.  A table
    that overflows them goes to the paranoid decode when
    ``overflow_fallback`` is set (inventory.py:373-423): one read of the
    overflow flag, after the specialized decode is queued."""
    dec, overflow = _decode_events_queued(y, events, cfg, specialize)
    if overflow_fallback and overflow is not None and profiling.host_read(overflow):
        return _decode_events_paranoid(y, events, dec.cmd_type, cfg)
    return dec


def _compact_rows(mask: torch.Tensor, sub_cap: int) -> torch.Tensor:
    """(sub_cap,) row indices of the first sub_cap set entries of mask, in
    order; unfilled rows hold len(mask) (the invalid fill)."""
    cap = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    slot = torch.where(mask, torch.clamp(pos, max=sub_cap), sub_cap)
    rows = torch.full((sub_cap + 1,), cap, dtype=torch.int64, device=dev)
    rows = rows.scatter(0, slot.to(torch.int64), torch.arange(cap, device=dev))
    return rows[:sub_cap]


def _decode_specialized(y_c, events_c: GateEvents, cmd, role_q, role_a, cap_q: int,
                        cfg: ReaderConfig) -> DecodedEvents:
    """Role-specialized decode of C channels' event tables as one flat batch:
    y_c (C, n) complex64, the tables' leaves (C, cap).  Each channel's
    role_q / role_a events are compacted to cap_q rows, their windows
    gathered from the channel's own y (gather_aligned_windows_multi) and the
    results scattered back, channel c's private drop slot at flat row
    c*(cap+1)+cap.  Leaves come back (C, cap, ...)."""
    c, cap = events_c.index.shape
    n = y_c.shape[1]
    dev = y_c.device
    capp = cap + 1
    chan_base = torch.arange(c, device=dev)[:, None] * capp

    def flat_rows(mask):
        rows = torch.stack([_compact_rows(mask[k], cap_q) for k in range(c)])
        return (chan_base + rows).reshape(-1)

    fq, fa = flat_rows(role_q), flat_rows(role_a)

    def padded(v, fill):
        return torch.cat([v, v.new_full((c, 1), fill)], dim=1).reshape(-1)

    idx_pad = padded(events_c.index, n)
    dc_pad = padded(events_c.dc, 0)

    def gather_windows(rows, width):
        start = torch.clamp(idx_pad[rows], max=n - 1)
        fr = gather_aligned_windows_multi(y_c, start, rows // capp, width) - dc_pad[rows][:, None]
        return fr, (fr.real ** 2 + fr.imag ** 2).to(torch.float32)

    q_frames, q_magn2 = gather_windows(fq, cfg.rn16_window)
    a_frames, a_magn2 = gather_windows(fa, cfg.epc_window)
    q_bits, q_h, q_margin = _decode_rn16_frames(q_frames, cfg)
    a_bits, a_thalf, a_h, a_rel = _decode_epc_frames(a_frames, a_magn2, cfg)
    a_pass, a_tid, a_bits = _validate_epc_soft(a_bits, a_rel, cfg)
    q_energy = q_magn2.mean(dim=1)
    q_h2 = q_h.real ** 2 + q_h.imag ** 2
    q_state = classify_slots(q_energy, q_margin, padded(events_c.noise_var, 1.0)[fq], q_h2)

    def scatter(rows, vals, *shape, dtype=_I32, fill=0):
        out = torch.full((c * capp,) + shape, fill, dtype=dtype, device=dev)
        out[rows] = vals.to(dtype)
        return out.reshape((c, capp) + shape)[:, :cap]

    f32 = torch.float32
    h_full = torch.zeros((c * capp,), dtype=q_h.dtype, device=dev)
    h_full[fq] = q_h
    h_full[fa] = a_h
    return DecodedEvents(
        index=events_c.index,
        valid=events_c.valid,
        rn16_fits=events_c.valid & (events_c.index + cfg.rn16_window <= n),
        epc_fits=events_c.valid & (events_c.index + cfg.epc_window <= n),
        rn16_bits=scatter(fq, q_bits, 16),
        epc_bits=scatter(fa, a_bits, a_bits.shape[1]),
        epc_pass=scatter(fa, a_pass, dtype=torch.bool),
        tag_id=scatter(fa, a_tid),
        t_half=scatter(fa, a_thalf, dtype=f32),
        h_est=_h_planes(h_full.reshape(c, capp)[:, :cap]),
        slot_state=scatter(fq, q_state, fill=-1),
        rn16_energy=scatter(fq, q_energy, dtype=f32),
        rn16_margin=scatter(fq, q_margin, dtype=f32),
        cmd_type=cmd,
    )


@profiling.spanned("gen2.decode_events")
def decode_events_multi(y_c: torch.Tensor, events_c: GateEvents, cfg: ReaderConfig
                        ) -> DecodedEvents:
    """Role-specialized decode of C channels' event tables as one flat batch
    (inventory.py:510-621): y_c (C, n) complex64, events_c leaves (C, cap).

    Equal to ``decode_events(specialize=True, overflow_fallback=False)``
    channel by channel, which is its C = 1 case.  Leaves come back (C, cap,
    ...)."""
    c, cap = events_c.index.shape
    cap_q = min(cap, cap // 2 + 1 + ROLE_SLACK)
    cmd = classify_commands(events_c.n_pulses.reshape(-1), cfg).reshape(c, cap)
    role_q, role_a = command_roles(cmd, events_c.valid)
    return _decode_specialized(y_c, events_c, cmd, role_q, role_a, cap_q, cfg)


def replay_inventory_scan(dec: DecodedEvents, cfg: ReaderConfig) -> InventoryStats:
    """Event-level Gen2 round FSM replay, sequential and exact for any table
    (inventory.py:624-715; tag_decoder_impl.cc:256-394, gate_impl.cc:101-109).
    It walks the table on the host: a few integer updates per event."""
    idx, valid, rn_fit, epc_fit, ok, tid, sstate, ctype = (
        profiling.host_read(t) for t in (dec.index, dec.valid, dec.rn16_fits,
                                         dec.epc_fits, dec.epc_pass, dec.tag_id,
                                         dec.slot_state, dec.cmd_type))
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
        is_q = proc and qlike
        is_a = proc and is_ack
        if is_q:
            n_q += 1
            slot_counts[min(max(int(sstate[k]), 0), 2)] += 1
        if proc:
            cmd_counts[min(max(c, 0), 5)] += 1
        if is_a:
            t = int(tid[k])
            if ok[k]:
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
        if is_q:
            ptr = int(idx[k]) + cfg.rn16_window
        elif is_a:
            ptr = int(idx[k]) + cfg.epc_window
    dev = dec.index.device

    def t(v, dtype=_I32):
        return profiling.to_device(np.asarray(v), dev, dtype)

    return InventoryStats(
        n_queries=t(n_q), cur_inventory_round=t(rnd), cur_slot=t(slot),
        n_epc_correct=t(n_ok), tag_reads=t(reads), unique_tags_round=t(uni_hist),
        n_rounds_closed=t(n_rounds), n_events=dec.valid.sum(dtype=_I32),
        terminated=t(term, torch.bool), n_slot_empty=t(slot_counts[0]),
        n_slot_single=t(slot_counts[1]), n_slot_collision=t(slot_counts[2]),
        cmd_counts=t(cmd_counts),
    )


def _processed(dec: DecodedEvents):
    """(role_q, role_epc, fit_v, unfit_seen, proc): the roles, whether each
    event's window fits, whether an unfit event came before it, and the
    processed events (valid ones in the largest all-fit prefix)."""
    role_q, role_epc = command_roles(dec.cmd_type, dec.valid)
    fit_v = torch.where(dec.valid, torch.where(role_epc, dec.epc_fits, dec.rn16_fits),
                        True)
    unfit_seen = torch.cumsum((~fit_v).to(_I32), 0) > 0
    return role_q, role_epc, fit_v, unfit_seen, dec.valid & fit_v & ~unfit_seen


def _tag_histogram(passed: torch.Tensor, tag_id: torch.Tensor) -> torch.Tensor:
    reads = torch.zeros(N_TAG_BINS + 1, dtype=_I32, device=passed.device)
    sel = torch.where(passed, tag_id, N_TAG_BINS).to(torch.int64)
    return reads.index_add(0, sel, torch.ones_like(sel, dtype=_I32))[:N_TAG_BINS]


def _replay_fast_ok(dec: DecodedEvents, cfg: ReaderConfig) -> torch.Tensor:
    """Preconditions of the closed-form replay (inventory.py:718-747), as a
    0-d device flag: every valid event classified, unfit events only as a
    trailing run, processed events at least one window apart, termination
    limits not reached."""
    role_q, role_epc, fit_v, unfit_seen, proc = _processed(dec)
    valid = dec.valid
    all_known = torch.all(~valid | role_q | role_epc)
    refit_after_unfit = torch.any(valid & fit_v & unfit_seen)
    window = torch.where(role_epc, cfg.epc_window, cfg.rn16_window)
    nxt = torch.cat([dec.index[1:], dec.index.new_full((1,), NO_NEXT_EVENT)])
    gap_ok = ~proc | (nxt >= dec.index + window)
    n_q = (proc & role_q).sum()
    reads = _tag_histogram(proc & role_epc & dec.epc_pass, dec.tag_id)
    n_uni = (reads > 0).sum()
    return (all_known & ~refit_after_unfit & torch.all(gap_ok)
            & (n_q <= cfg.max_num_queries) & (n_uni <= cfg.max_unique_tags))


def _first_passes(passed: torch.Tensor, tag_id: torch.Tensor) -> torch.Tensor:
    """Rows that are the first pass of their tag id in the table: each tag
    id's least passed row, by a scatter-min of row numbers into its bin.
    O(E), where the JAX package's cumsum of an (E, 257) one-hot
    (inventory.py:829-836) is O(E * 257); the same flags, with no sync."""
    e = passed.shape[0]
    rows = torch.arange(e, device=passed.device)
    tid = torch.where(passed, tag_id, N_TAG_BINS).to(torch.int64)
    first = torch.full((N_TAG_BINS + 1,), e, dtype=torch.int64, device=passed.device
                       ).scatter_reduce_(0, tid, rows, "amin")
    return passed & (first[tid] == rows)


def _replay_fast_stats(dec: DecodedEvents, cfg: ReaderConfig) -> InventoryStats:
    """Closed-form replay for well-formed tables (inventory.py:800-862)."""
    e = dec.index.shape[0]
    dev = dec.index.device
    max_slot = cfg.max_slot_number
    role_q, role_epc, _, _, proc = _processed(dec)
    passed = proc & role_epc & dec.epc_pass
    reads = _tag_histogram(passed, dec.tag_id)
    epc_proc = proc & role_epc
    a = epc_proc.sum(dtype=_I32)
    n_rounds = a // max_slot
    uni_run = torch.cumsum(_first_passes(passed, dec.tag_id).to(_I32), 0, dtype=_I32)
    epc_rank = torch.cumsum(epc_proc.to(_I32), 0, dtype=_I32)      # 1-based
    wrap = epc_proc & (epc_rank % max_slot == 0)
    round_idx = torch.where(wrap, epc_rank // max_slot - 1, e).to(torch.int64)
    uni_hist = torch.zeros(e + 1, dtype=_I32, device=dev).index_add(
        0, round_idx, uni_run)[:e]
    qs = proc & role_q
    cmd_sel = torch.where(proc, torch.clamp(dec.cmd_type, 0, 5), 6).to(torch.int64)
    cmd_counts = torch.zeros(7, dtype=_I32, device=dev).index_add(
        0, cmd_sel, torch.ones_like(cmd_sel, dtype=_I32))[:6]
    return InventoryStats(
        n_queries=qs.sum(dtype=_I32),
        cur_inventory_round=1 + n_rounds,
        cur_slot=1 + a % max_slot,
        n_epc_correct=passed.sum(dtype=_I32),
        tag_reads=reads,
        unique_tags_round=uni_hist,
        n_rounds_closed=n_rounds,
        n_events=dec.valid.sum(dtype=_I32),
        terminated=torch.zeros((), dtype=torch.bool, device=dev),
        n_slot_empty=(qs & (dec.slot_state == 0)).sum(dtype=_I32),
        n_slot_single=(qs & (dec.slot_state == 1)).sum(dtype=_I32),
        n_slot_collision=(qs & (dec.slot_state == 2)).sum(dtype=_I32),
        cmd_counts=cmd_counts,
    )


# Tables replayed, by route: the closed form, or the sequential scan when
# its preconditions fail.  Host ints, counted without a sync.
replays = {"closed_form": 0, "scan": 0}
# decode_block's tables whose one read found the role tables overflowed, so
# that they were decoded again by the paranoid decode.  A host int, counted
# without a sync.
redecodes = {"paranoid": 0}


def _replay_tables(decs, cfg: ReaderConfig, overflow: torch.Tensor = None):
    """Each table's replay (inventory.py:772-797): every table's closed form
    is queued behind its preconditions' device flag, then one read takes
    every flag (and ``overflow``'s, when given), and a table whose flag
    fails gets the exact sequential scan.  None, with nothing counted, where
    ``overflow`` reads true."""
    oks = [_replay_fast_ok(d, cfg) for d in decs]
    fast = [_replay_fast_stats(d, cfg) for d in decs]
    if overflow is not None:
        oks.append(overflow)
    flags = profiling.host_read(torch.stack(oks))
    if overflow is not None and flags[-1]:
        return None
    stats = []
    for d, f, ok in zip(decs, fast, flags):
        replays["closed_form" if ok else "scan"] += 1
        stats.append(f if ok else replay_inventory_scan(d, cfg))
    return stats


@profiling.spanned("gen2.replay")
def replay_inventory(dec: DecodedEvents, cfg: ReaderConfig) -> InventoryStats:
    """Round FSM replay: the closed form when its preconditions hold, else
    the exact sequential scan (inventory.py:772-797)."""
    return _replay_tables([dec], cfg)[0]


@profiling.spanned("gen2.replay")
def replay_inventory_batch(dec_c: DecodedEvents, cfg: ReaderConfig) -> InventoryStats:
    """Per-channel replay of (C, cap) tables, each stats leaf stacked on a
    leading channel axis (inventory.py:750-769): each channel's closed form
    or scan, as its own preconditions say, with one read of every channel's
    verdict.  The same stats as replaying each channel alone."""
    decs = [DecodedEvents(*(f[k] for f in dec_c)) for k in range(dec_c.index.shape[0])]
    return InventoryStats(*(torch.stack(f) for f in zip(*_replay_tables(decs, cfg))))


def decode_block(y: torch.Tensor, cfg: ReaderConfig, flags: torch.Tensor = None,
                 exact_gate: bool = False, amp: torch.Tensor = None,
                 avg: torch.Tensor = None) -> Tuple[InventoryStats, DecodedEvents]:
    """Decode one post-decimation complex I/Q block (inventory.py:865-881).

    ``flags``: native mode's packed gate-stack flags of y, computed from y
    when not given; ``amp``/``avg``: |y| and its windowed average from the
    front end, which compat mode and the exact gate need.  Native mode
    decodes role-specialized windows; compat decodes every event as both
    windows, as the reference decoder runs both branches' arithmetic.

    The host waits on the device once, after the whole decode is queued:
    one read takes the role tables' overflow flag and the closed form's
    verdict together.  A table that overflowed is decoded again by the
    paranoid decode and replayed (``redecodes``); one that fails the closed
    form's preconditions is scanned.  The outputs are those of
    ``decode_events`` and ``replay_inventory`` in turn."""
    if exact_gate:
        events = gate_detect_scan(y, cfg, amp, avg)
    else:
        events = gate_detect(y, cfg, flags, amp, avg)
    with profiling.span("gen2.decode_events"):
        dec, overflow = _decode_events_queued(y, events, cfg, cfg.mode != "compat")
    with profiling.span("gen2.replay"):
        stats = _replay_tables([dec], cfg, overflow)
    if stats is None:
        redecodes["paranoid"] += 1
        dec = decode_events(y, events, cfg)
        return replay_inventory(dec, cfg), dec
    return stats[0], dec


def matched_taps(cfg: ReaderConfig):
    """Boxcar matched to half an FM0 symbol (or one Miller half-cycle) at ADC
    rate: 25 taps at the defaults (apps/reader.py:63-65)."""
    return boxcar_taps(front_taps(cfg))


def resolve_device(device=None) -> torch.device:
    """The device to decode on: ``device`` when given, else CUDA.  Without a
    device and without CUDA this raises: the port never falls back to the
    CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to decode on the CPU")
    return torch.device("cuda")


# decode_capture_planar's calls, on any device: a caller that holds a run's
# kernel launches to its decodes (one gate_front launch a decode, and one
# gate_stack launch a native one) reads it before and after the run.
decodes = {"capture": 0}


def decode_capture_planar(iq2, cfg: ReaderConfig, exact_gate: bool = False,
                          device=None) -> Tuple[InventoryStats, DecodedEvents]:
    """Full pipeline from a planar (2, N) float32 ADC-rate capture
    (inventory.py:890-919).

    ``cfg.cancel_cw`` first subtracts strong CW tones.  The front end
    (dsp/gate.py::front_end) takes y alone from its y build in native mode,
    as the JAX package's default path computes y alone, and the gate reads
    the gate-stack kernel's flags of y; compat mode and ``exact_gate`` take
    y, |y| and the windowed |y| sum from the full build and gate on |y| and
    avg = sum / win_length, which is the JAX package's ``pallas_front``
    path.  Runs on CUDA unless ``device`` says otherwise.  The call is the
    span ``gen2.decode_capture`` and the front end ``gen2.front``
    (utils/profiling.py)."""
    dev = resolve_device(device)
    decodes["capture"] += 1
    with profiling.span("gen2.decode_capture", allocator=dev, samples=np.shape(iq2)[-1]):
        with profiling.span("gen2.front"):
            x2 = torch.as_tensor(iq2, dtype=torch.float32)
            if x2.device.type == "cpu" and dev.type == "cuda":
                x2 = profiling.to_device(x2, dev)
            x2 = x2.to(dev).contiguous()
            if cfg.cancel_cw:
                x2 = cancel_cw_planar(x2, cfg.cancel_cw).contiguous()
            y, flags, amp, avg = front_end(x2, cfg, exact_gate)
        return decode_block(y, cfg, flags, exact_gate, amp, avg)


def to_planar(iq) -> torch.Tensor:
    """Host complex capture -> (2, N) float32 CPU tensor."""
    iq = np.asarray(iq)
    return torch.from_numpy(np.stack([iq.real.astype(np.float32),
                                      iq.imag.astype(np.float32)]))


def decode_capture(iq, cfg: ReaderConfig, exact_gate: bool = False, device=None
                   ) -> Tuple[InventoryStats, DecodedEvents]:
    """Full pipeline from a raw complex ADC-rate capture (host array)."""
    return decode_capture_planar(to_planar(iq), cfg, exact_gate, device)
