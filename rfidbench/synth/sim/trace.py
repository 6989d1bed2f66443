"""Closed-loop inventory trace synthesis (golden-trace generator).

Replaces the reference's missing ``gr-rfid/misc/data/file_source_test`` blob:
synthesizes the RX capture a USRP would record while the reference reader runs
an inventory (``apps/reader.py:101-112`` offline mode).  The trace contains,
per slot: the reader's own TX leakage (PIE Query/QueryRep then CW), the tag's
FM0 RN16 reply riding on the CW, the ACK command, and the EPC reply - exactly
the structure the gate/decoder chain expects (``gate_impl.cc:127-195``,
``tag_decoder_impl.cc:223-394``).

Timing notes (derived in SURVEY.md section 2.4): the gate opens 97
post-decimation samples (242.5 us) after the final rising edge of a command,
so the simulator starts tag replies slightly later than nominal T1 (default
252.5 us) to land the preamble a few samples into the decode window, inside
the decoder's 15-offset sync search.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ReaderConfig
from ..tx.pie import PieEncoder
from .tag import Tag, reply_chips, superpose_reply, tag_id_of_frame


@dataclasses.dataclass
class TraceEvent:
    """Ground truth for one command event in the synthesized capture."""

    kind: str                 # "query" | "query_rep" | "ack"
    cmd_start: int            # sample index (adc rate) of command start
    cmd_end: int              # sample index just past the command waveform
    reply_tag: Optional[int]  # index into tags, None if no/collided reply
    reply_bits: Optional[np.ndarray]
    collided: bool = False
    # Ground truth for collided slots: [(tag index, drawn RN16), ...]
    collider_bits: Optional[list] = None
    # Ground truth for same-RN16 collisions: the EPC frames superposed in
    # this ACK's reply window, [(tag index, 128 frame bits), ...].
    epc_frames: Optional[list] = None


@dataclasses.dataclass
class SynthesizedTrace:
    iq: np.ndarray            # complex64 at cfg.adc_rate
    events: List[TraceEvent]
    n_slots: int
    n_rounds: int
    expected_epc_pass: int    # number of slots whose EPC should CRC-check
    expected_tag_reads: Dict[int, int]  # reference-style tag id -> reads


class _Writer:
    """Append-only complex baseband assembler at ADC rate."""

    def __init__(self, cfg: ReaderConfig, leak: complex):
        self.cfg = cfg
        self.sp_us = cfg.adc_rate / 1e6          # samples per microsecond
        self.up = int(round(cfg.adc_rate / cfg.dac_rate))
        self.leak = np.complex64(leak)
        self.parts: List[np.ndarray] = []
        self.n = 0
        # Carrier polarity across segments (PR-ASK phase reversals leave
        # the carrier at ±1; CW must continue at that phase - see
        # sim/channel.py).  Stays +1 for DSB/SSB.
        self.pol = np.complex64(1.0)

    def append_envelope(self, env_1msps: np.ndarray) -> int:
        """TX baseband (DAC rate; 0/1 envelope, or signed/complex for
        PR/SSB-ASK) -> leak-scaled carrier at ADC rate."""
        seg = (np.repeat(env_1msps.astype(np.complex64), self.up)
               * self.leak * self.pol)
        if env_1msps.size and float(np.real(env_1msps[-1])) < 0:
            self.pol = -self.pol
        self.parts.append(seg)
        start = self.n
        self.n += seg.size
        return start

    def add_reply(
        self,
        seg: np.ndarray,
        chips: np.ndarray,
        reply_offset_us: float,
        backscatter: complex,
        chip_us: float,
        cfo_hz: float = 0.0,
        amp_ramp: float = 0.0,
    ) -> None:
        """Superpose one tag's backscatter chips onto a CW segment in place.

        Delegates to sim.tag.superpose_reply (shared with the interactive
        channel so both synthesizers have identical chip-edge conventions).
        """
        superpose_reply(seg, chips, reply_offset_us, backscatter, chip_us,
                        self.sp_us, self.cfg.adc_rate, cfo_hz, amp_ramp)

    def append_cw_with_reply(
        self,
        cw_us: float,
        reply: Optional[np.ndarray],
        reply_offset_us: float,
        backscatter: complex,
        chip_us: float,
        cfo_hz: float = 0.0,
        amp_ramp: float = 0.0,
    ) -> int:
        """CW segment with an optional backscatter chip sequence added."""
        n = int(round(cw_us * self.sp_us))
        seg = np.full(n, self.leak * self.pol, dtype=np.complex64)
        if reply is not None:
            self.add_reply(seg, reply, reply_offset_us,
                           backscatter * complex(self.pol), chip_us,
                           cfo_hz, amp_ramp)
        self.parts.append(seg)
        start = self.n
        self.n += n
        return start

    def concat(self, rng: np.random.Generator, noise: float) -> np.ndarray:
        iq = np.concatenate(self.parts) if self.parts else np.zeros(0, np.complex64)
        if noise > 0:
            iq = iq + (
                rng.normal(0, noise / np.sqrt(2), iq.size)
                + 1j * rng.normal(0, noise / np.sqrt(2), iq.size)
            ).astype(np.complex64)
        return iq.astype(np.complex64)


def synthesize_inventory(
    cfg: ReaderConfig,
    tags: Sequence[Tag],
    n_rounds: int,
    *,
    corrupt_slots: Sequence[int] = (),
    leak: complex = 1.0,
    noise: float = 0.004,
    tag_t1_us: float = 252.5,
    lead_cw_us: Optional[float] = None,
    tail_cw_us: float = 1000.0,
    seed: int = 1234,
) -> SynthesizedTrace:
    """Run the reader FSM in simulation and synthesize the RX capture.

    ``corrupt_slots``: global slot indices whose EPC reply gets a flipped
    payload bit (CRC will fail) - used to reproduce the golden trace's one
    failed decode out of 71 (README.md:48-53).
    """
    rng = np.random.default_rng(seed)
    enc = PieEncoder(cfg)
    w = _Writer(cfg, leak)
    chip_us = cfg.tag_bit_us / (2 * cfg.miller_m)
    q = cfg.fixed_q
    n_slots_round = 2**q

    # Reader starts by emitting a long CW burst (reader_impl.cc:218-224 START
    # state sends cw_ack) - warms up the gate's moving average.
    if lead_cw_us is None:
        lead_cw_us = float(3 * cfg.t1_us + cfg.t2_us + cfg.epc_us)
    w.append_cw_with_reply(lead_cw_us, None, 0.0, 0.0, chip_us)

    events: List[TraceEvent] = []
    expected_pass = 0
    tag_reads: Dict[int, int] = {}
    global_slot = 0

    for _ in range(n_rounds):
        # Each tag draws a slot for this round.
        slots = [t.draw_slot(q) for t in tags]
        for s in range(n_slots_round):
            responders = [i for i, sl in enumerate(slots) if sl == s]
            single = len(responders) == 1
            tag_i = responders[0] if single else None

            # ---- Query (first slot) or QueryRep ----
            cmd = enc.query() if s == 0 else enc.query_rep()
            kind = "query" if s == 0 else "query_rep"
            c0 = w.append_envelope(cmd)
            c1 = w.n

            # RN16 reply during cw_query.
            colliders = None
            if single:
                rn16 = tags[tag_i].draw_rn16()
                reply = reply_chips(cfg, rn16)
                bs = tags[tag_i].channel_phasor(cfg, w.n / cfg.adc_rate)
            elif responders:           # collision: superpose both replies
                rn16 = rng.integers(0, 2, 16).astype(np.int64)
                reply = None           # superposition handled below
                bs = 0.0
            else:
                rn16 = rng.integers(0, 2, 16).astype(np.int64)
                reply, bs = None, 0.0
            cw_q_us = cfg.t1_us + cfg.t2_us + cfg.rn16_us
            if responders and not single:
                # Collision: write CW then add each tag's chips.
                w.append_cw_with_reply(cw_q_us, None, 0.0, 0.0, chip_us)
                seg = w.parts[-1]
                colliders = []  # ground truth for this collided slot
                for i in responders:
                    t = tags[i]
                    drawn = t.draw_rn16()
                    colliders.append((i, drawn))
                    w.add_reply(seg, reply_chips(cfg, drawn),
                                tag_t1_us + rng.uniform(0, 5),
                                t.channel_phasor(
                                    cfg, (w.n - seg.size) / cfg.adc_rate),
                                t.chip_us(cfg), t.cfo_hz,
                                t.amp_ramp)
                if len({tuple(int(x) for x in d)
                        for _, d in colliders}) == 1:
                    # All colliders drew the SAME RN16: the ACK matches
                    # every one of them (Gen2), so all reply with their
                    # EPC frames superposed - the batch EPC-SIC scenario.
                    rn16 = colliders[0][1]
            else:
                t = tags[tag_i] if single else None
                w.append_cw_with_reply(
                    cw_q_us, reply, tag_t1_us, bs,
                    t.chip_us(cfg) if single else chip_us,
                    t.cfo_hz if single else 0.0,
                    t.amp_ramp if single else 0.0,
                )
            events.append(
                TraceEvent(kind, c0, c1, tag_i, rn16 if single else None,
                           collided=len(responders) > 1,
                           collider_bits=colliders)
            )

            # ---- ACK + EPC reply during cw_ack ----
            same_rn = (colliders is not None and len(
                {tuple(int(x) for x in d) for _, d in colliders}) == 1)
            a0 = w.append_envelope(enc.ack(rn16))
            a1 = w.n
            epc_reply = None
            frame = None
            epc_frames = None
            if single:
                frame = tags[tag_i].epc_frame_bits()
                if global_slot in corrupt_slots:
                    frame = frame.copy()
                    frame[40] ^= 1     # payload bit flip -> CRC fail
                else:
                    expected_pass += 1
                    tid = tag_id_of_frame(frame)
                    tag_reads[tid] = tag_reads.get(tid, 0) + 1
                epc_reply = reply_chips(cfg, frame)
            cw_a_us = 3 * cfg.t1_us + cfg.t2_us + cfg.epc_us
            if same_rn:
                # Same-RN16 collision: every collider matches the ACK and
                # backscatters its EPC frame - superposed in one window.
                w.append_cw_with_reply(cw_a_us, None, 0.0, 0.0, chip_us)
                seg = w.parts[-1]
                epc_frames = []
                for i, _ in colliders:
                    t = tags[i]
                    fr = t.epc_frame_bits()
                    epc_frames.append((i, fr))
                    w.add_reply(seg, reply_chips(cfg, fr),
                                tag_t1_us + rng.uniform(0, 5),
                                t.channel_phasor(
                                    cfg, (w.n - seg.size) / cfg.adc_rate),
                                t.chip_us(cfg), t.cfo_hz,
                                t.amp_ramp)
                # The plain pipeline capture-decodes the dominant tag.
                dom = max((tags[i] for i, _ in colliders),
                          key=lambda t: abs(t.backscatter))
                expected_pass += 1
                tid = tag_id_of_frame(dom.epc_frame_bits())
                tag_reads[tid] = tag_reads.get(tid, 0) + 1
            else:
                t = tags[tag_i] if single else None
                w.append_cw_with_reply(
                    cw_a_us, epc_reply, tag_t1_us,
                    t.channel_phasor(cfg, w.n / cfg.adc_rate) if single else 0.0,
                    t.chip_us(cfg) if single else chip_us,
                    t.cfo_hz if single else 0.0,
                    t.amp_ramp if single else 0.0,
                )
            events.append(TraceEvent("ack", a0, a1, tag_i, frame,
                                     collided=same_rn,
                                     epc_frames=epc_frames))
            global_slot += 1

    w.append_cw_with_reply(tail_cw_us, None, 0.0, 0.0, chip_us)
    iq = w.concat(rng, noise)
    return SynthesizedTrace(
        iq=iq,
        events=events,
        n_slots=global_slot,
        n_rounds=n_rounds,
        expected_epc_pass=expected_pass,
        expected_tag_reads=tag_reads,
    )


def synthesize_adaptive_inventory(
    cfg: ReaderConfig,
    tags: Sequence[Tag],
    n_slots: int,
    *,
    q_init: int = 2,
    q_c: float = 0.35,
    leak: complex = 1.0,
    noise: float = 0.004,
    tag_t1_us: float = 262.5,
    seed: int = 77,
) -> SynthesizedTrace:
    """Closed-loop inventory with the Gen2 Annex D Q-algorithm.

    The reference ships QueryAdjust synthesis and the Q_UPDN table but pins
    FIXED_Q and never adjusts (reader_impl.cc:156-162, global_vars.h:130-133);
    this simulator drives the classic adaptation: Qfp += C on a collision,
    -= C on an empty slot; when round(Qfp) changes the reader issues
    QueryAdjust (starting a new round, tags redraw slots), otherwise it
    walks the remaining slots with QueryRep and starts the next round with
    Query.
    """
    rng = np.random.default_rng(seed)
    enc = PieEncoder(cfg)
    w = _Writer(cfg, leak)
    chip_us = cfg.tag_bit_us / (2 * cfg.miller_m)
    events: List[TraceEvent] = []
    expected_pass = 0
    tag_reads: Dict[int, int] = {}

    lead_cw_us = float(3 * cfg.t1_us + cfg.t2_us + cfg.epc_us)
    w.append_cw_with_reply(lead_cw_us, None, 0.0, 0.0, chip_us)

    qfp = float(q_init)
    q = q_init
    slots_left = 0
    next_cmd = "query"

    for _ in range(n_slots):
        # ---- command opening this slot ----
        if next_cmd == "query":
            cmd, kind = enc.query(), "query"
            slots_left = 2**q
            slot_draws = [t.draw_slot(q) for t in tags]
            slot_no = 0
        elif next_cmd == "query_adjust":
            updn = +1 if round(qfp) > q else (-1 if round(qfp) < q else 0)
            q = int(np.clip(round(qfp), 0, 15))
            cmd, kind = enc.query_adjust(updn), "query_adjust"
            slots_left = 2**q
            slot_draws = [t.draw_slot(q) for t in tags]
            slot_no = 0
        else:
            cmd, kind = enc.query_rep(), "query_rep"
            slot_no += 1

        responders = [i for i, sl in enumerate(slot_draws) if sl == slot_no]
        single = len(responders) == 1
        tag_i = responders[0] if single else None

        c0 = w.append_envelope(cmd)
        c1 = w.n
        rn16 = (tags[tag_i].draw_rn16() if single
                else rng.integers(0, 2, 16).astype(np.int64))
        reply = reply_chips(cfg, rn16) if single else None
        bs = (tags[tag_i].channel_phasor(cfg, w.n / cfg.adc_rate)
              if single else 0.0)
        cw_q_us = cfg.t1_us + cfg.t2_us + cfg.rn16_us
        if responders and not single:
            w.append_cw_with_reply(cw_q_us, None, 0.0, 0.0, chip_us)
            seg = w.parts[-1]
            for i in responders:
                t = tags[i]
                r = reply_chips(cfg, t.draw_rn16())
                w.add_reply(seg, r, tag_t1_us + rng.uniform(0, 5),
                            t.channel_phasor(
                                cfg, (w.n - seg.size) / cfg.adc_rate),
                            t.chip_us(cfg), t.cfo_hz, t.amp_ramp)
        else:
            t = tags[tag_i] if single else None
            w.append_cw_with_reply(
                cw_q_us, reply, tag_t1_us, bs,
                t.chip_us(cfg) if single else chip_us,
                t.cfo_hz if single else 0.0,
                t.amp_ramp if single else 0.0,
            )
        events.append(TraceEvent(kind, c0, c1, tag_i, rn16 if single else None,
                                 collided=len(responders) > 1))

        a0 = w.append_envelope(enc.ack(rn16))
        frame = None
        epc_reply = None
        if single:
            frame = tags[tag_i].epc_frame_bits()
            expected_pass += 1
            tid = tag_id_of_frame(frame)
            tag_reads[tid] = tag_reads.get(tid, 0) + 1
            epc_reply = reply_chips(cfg, frame)
        cw_a_us = 3 * cfg.t1_us + cfg.t2_us + cfg.epc_us
        t = tags[tag_i] if single else None
        w.append_cw_with_reply(
            cw_a_us, epc_reply, tag_t1_us,
            t.channel_phasor(cfg, w.n / cfg.adc_rate) if single else 0.0,
            t.chip_us(cfg) if single else chip_us,
            t.cfo_hz if single else 0.0,
            t.amp_ramp if single else 0.0,
        )
        events.append(TraceEvent("ack", a0, w.n, tag_i, frame))

        # ---- Q adaptation (Annex D) ----
        if len(responders) > 1:
            qfp = min(qfp + q_c, 15.0)
        elif not responders:
            qfp = max(qfp - q_c, 0.0)
        slots_left -= 1
        if round(qfp) != q:
            next_cmd = "query_adjust"
        elif slots_left <= 0:
            next_cmd = "query"
        else:
            next_cmd = "query_rep"

    w.append_cw_with_reply(1000.0, None, 0.0, 0.0, chip_us)
    iq = w.concat(rng, noise)
    return SynthesizedTrace(
        iq=iq, events=events, n_slots=n_slots,
        n_rounds=sum(1 for e in events if e.kind in ("query", "query_adjust")),
        expected_epc_pass=expected_pass,
        expected_tag_reads=tag_reads,
    )


def golden_trace(cfg: Optional[ReaderConfig] = None, seed: int = 1234) -> SynthesizedTrace:
    """Regenerate a file_source_test-equivalent capture.

    Expected decode: 71 queries detected, final round 72, 70 correct EPCs,
    1 unique tag with ID 27 (README.md:43-53).
    """
    cfg = cfg or ReaderConfig()
    tag = Tag.with_id(27, seed=7)
    return synthesize_inventory(
        cfg, [tag], n_rounds=71, corrupt_slots=[35], seed=seed
    )
