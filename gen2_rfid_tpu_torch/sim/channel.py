"""Interactive tag channel: the air interface for closed-loop operation.

Unlike `trace.py` (which pre-records the whole exchange), this channel is
driven one transmission at a time and the tags *react to the commands they
receive*: slot counters decrement on QueryRep, and - crucially - a tag only
backscatters its EPC if the ACK echoes the exact RN16 it sent
(Gen2 protocol, the property the reference's live mode exercises through a
real tag, ``README.md:87-100``).  This makes the closed loop a real test of
the reader's RN16 decode: a single wrong bit silences the tag.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..config import ReaderConfig
from .tag import Tag, reply_chips, superpose_reply


@dataclasses.dataclass
class _TagState:
    tag: Tag
    slot: int = -1               # current slot counter (-1 = not participating)
    rn16: Optional[np.ndarray] = None
    # Per-session inventoried flags S0-S3 (False=A, True=B), Gen2 6.3.2.3:
    # each session's flag is independent, so readers inventorying in
    # different sessions do not clobber each other's passes.
    flags: List[bool] = dataclasses.field(
        default_factory=lambda: [False] * 4)
    sl: bool = False             # SL flag (asserted/deasserted by Select)
    s1_set_t: float = 0.0        # channel time the S1 flag last became B
    #                              (Gen2 6.3.2.3: S1 decays on its own
    #                              timer, 500 ms - 5 s, power or not)
    acked: bool = False          # in Acknowledged state (valid ACK received)
    handle: Optional[np.ndarray] = None   # Open-state handle (post Req_RN)
    cover_rn: Optional[np.ndarray] = None  # fresh RN16 for Write cover-coding
    secured: bool = False        # Secured state (valid Access sequence, or
    #                              zero access pwd at Req_RN, Gen2 6.3.2.4)
    truncate_from: Optional[int] = None  # Select Truncate=1: EPC-bank bit
    #                              address where the truncated ACK reply
    #                              starts (= pointer + mask length)
    access_step: int = 0         # Access halves verified so far (0/1)
    kill_step: int = 0           # Kill halves verified so far (0/1)
    response_buffer: Optional[np.ndarray] = None  # Gen2 v2 ResponseBuffer:
    #                              the Challenge-precomputed TAM1 response
    #                              (persists until the next Challenge or
    #                              power loss, Gen2 v2 6.3.2.12.3.10)
    pending_flip: bool = False   # valid ACK received; flag flips at the
    #                              next non-NAK command (Gen2 6.3.2.4: a NAK
    #                              returns the tag to arbitrate WITHOUT
    #                              toggling its inventoried flag)
    flip_session: int = 0        # which session's flag the pending flip hits
    sc_ctr: int = 0              # SecureComm exchange counter within the
    #                              current TAM1 session (both sides count)

    # Legacy single-session view (S0, the default config session) used by
    # existing tests and the reference-parity paths.
    @property
    def flag_b(self) -> bool:
        return self.flags[0]

    @flag_b.setter
    def flag_b(self, v: bool) -> None:
        self.flags[0] = bool(v)


class SimTagChannel:
    """Air-interface simulator for one reader and a population of tags."""

    def __init__(
        self,
        cfg: ReaderConfig,
        tags: Sequence[Tag],
        *,
        leak: complex = 1.0,
        noise: float = 0.004,
        tag_t1_us: float = 262.5,
        seed: int = 99,
        session_ab: bool = False,
        error_replies: bool = True,
        interferers: Optional[dict] = None,
        s1_persistence_s: float = 2.0,
    ):
        self.cfg = cfg
        self.tags = [_TagState(t) for t in tags]
        # session_ab=True models real Gen2 inventoried flags: a Query's
        # Target bit selects which population (A/B) participates, and a
        # singulated tag toggles its flag - so a pass progressively
        # silences read tags.  False (default) reproduces the reference's
        # observed behavior (every round re-reads every tag: 70 reads of
        # one tag on the golden trace, README.md:52-53; S0 persistence is
        # short against its ~2 s capture).
        self.session_ab = session_ab
        # Gen2 Annex I error-specific replies: a failed handle-addressed
        # access command backscatters header-1 + ErrorCode + handle + CRC
        # instead of staying silent (password failures stay silent by
        # spec).  False models older silicon that just doesn't answer.
        self.error_replies = error_replies
        self.leak = np.complex64(leak)
        self.noise = noise
        self.tag_t1_us = tag_t1_us
        self.s1_persistence_s = float(s1_persistence_s)
        self.rng = np.random.default_rng(seed)
        self.up = int(round(cfg.adc_rate / cfg.dac_rate))
        self.sp_us = cfg.adc_rate / 1e6
        self.chip_us = cfg.tag_bit_us / (2 * cfg.miller_m)
        # Tags learn Q from the commands themselves (parsed from the Query's
        # Q field / QueryAdjust's UpDn bits), so an adaptive reader works
        # against this channel with no side channel.
        self.q = cfg.fixed_q
        # Running capture time (samples at ADC rate) so moving tags'
        # round-trip phase evolves across exchanges (Tag.channel_phasor).
        self.t_samples = 0
        # Current carrier (FCC hopping: LiveReader.retune mid-session
        # changes the round-trip phase per hop - the live PDOA observable).
        self.carrier_hz = float(cfg.freq_hz)
        # Other readers' carriers on the band: {rf_hz: dbc relative to
        # this reader's leak}.  Each appears in the RX at its offset
        # from the CURRENT carrier (skipped beyond the ADC Nyquist), so
        # re-tuning away from a busy channel clears it - the observable
        # LBT (listen-before-talk) acts on.
        self.interferers = dict(interferers or {})
        # Carrier polarity carried across exchanges (PR-ASK, Gen2
        # 6.3.1.2): each command's phase reversals leave the carrier at
        # ±1, and the following CW must continue at that phase - a sign
        # jump at the junction would look like a spurious PIE pulse to
        # the gate.  +1 forever for DSB/SSB (their baseband never goes
        # negative), so the tracking is mode-agnostic.
        self._pol = np.complex64(1.0)
        # Reply-link parameters COMMANDED by the reader: real tags take
        # their backscatter encoding (M) and preamble (TRext) from each
        # Query's fields (Gen2 6.3.2.12.1), not from any shared config -
        # the physical basis of reader-side link-rate adaptation
        # (runtime/live.py link_profiles).  Starts at the constructor
        # config and follows every parsed Query.
        self.link_cfg = cfg

    def retune(self, freq_hz: float) -> None:
        """Hop the reader carrier (FCC 902-928 MHz channel plan): tag
        backscatter phase thereafter reflects the new frequency."""
        self.carrier_hz = float(freq_hz)

    # ---- tag protocol reactions ----

    def _now_s(self) -> float:
        return self.t_samples / self.cfg.adc_rate

    def _commit_flips(self):
        """Acknowledged tags toggle their (round's session's) inventoried
        flag at the next command (any command except NAK, which cancels
        the transition)."""
        for ts in self.tags:
            if ts.pending_flip:
                ts.flags[ts.flip_session] = not ts.flags[ts.flip_session]
                if ts.flip_session == 1 and ts.flags[1]:
                    ts.s1_set_t = self._now_s()
                ts.pending_flip = False

    def _expire_s1(self):
        """Gen2 6.3.2.3: the S1 inventoried flag persists 500 ms - 5 s on
        its OWN timer (powered or not) and then reverts to A — unlike S0
        (dies with power) and S2/S3 (persist while powered).  Lazily
        evaluated against the channel's sample clock at every exchange."""
        now = self._now_s()
        for ts in self.tags:
            if ts.flags[1] and now - ts.s1_set_t > self.s1_persistence_s:
                ts.flags[1] = False

    def _on_query(self, q: int, target: int = 0, sel=(0, 0),
                  session: int = 0):
        from ..protocol.gen2 import SEL_NOT_SL, SEL_SL

        for ts in self.tags:
            participates = ((not self.session_ab
                             or ts.flags[session] == bool(target))
                            and not ts.tag.killed)
            if sel == SEL_SL:
                participates = participates and ts.sl
            elif sel == SEL_NOT_SL:
                participates = participates and not ts.sl
            ts.slot = ts.tag.draw_slot(q) if participates else -1
            ts.rn16 = None
            ts.acked = False
            ts.handle = None
            ts.cover_rn = None
            ts.secured = False
            ts.access_step = 0
            ts.kill_step = 0

    def _responders(self) -> List[_TagState]:
        return [ts for ts in self.tags if ts.slot == 0]

    # ---- the exchange ----

    def _exec_inner(self, ts, inner: np.ndarray, err):
        """Execute an AuthComm/SecureComm-encapsulated access command.

        Read and Write (the confidential-data use cases) are supported as
        inner frames; the inner frame is the full command incl. its own
        handle and CRC, so a wrong-key SecureComm decrypt almost surely
        fails the opcode/handle/CRC checks and the tag stays silent.
        Inner Write data is plain (the envelope supersedes cover-coding).
        Returns ("read", words) / ("write", None), or None (rejected;
        Annex-I error replies queued where the plain command would)."""
        from ..protocol import gen2

        code = tuple(int(x) for x in inner[:8])
        if code == gen2.READ_CODE and inner.size == 58:
            membank, wordptr, wordcount, ih, crc_ok = gen2.parse_read(inner)
            if not crc_ok or not np.array_equal(ih, ts.handle):
                return None
            mem = ts.tag.bank_bits(membank, secured=ts.secured)
            lo, hi = 16 * wordptr, 16 * (wordptr + wordcount)
            if mem is None:
                err(ts, "not supported")
            elif hi > mem.size:
                err(ts, "memory overrun")
            elif np.any(mem[lo:hi] < 0):
                err(ts, "memory locked")
            else:
                return ("read", mem[lo:hi])
            return None
        if code == gen2.WRITE_CODE and inner.size == 66:
            membank, wordptr, data, ih, crc_ok = gen2.parse_write(inner)
            if not crc_ok or not np.array_equal(ih, ts.handle):
                return None
            if ts.tag.write_word(membank, wordptr, data,
                                 secured=ts.secured):
                return ("write", None)
            if (not ts.tag.write_allowed(membank, ts.secured)
                    or (tuple(membank) == (1, 1)
                        and wordptr < ts.tag.user_permalock.size
                        and ts.tag.user_permalock[wordptr])):
                err(ts, "memory locked")
            else:
                err(ts, "memory overrun")
            return None
        return None

    def exchange(self, kind: str, bits: np.ndarray, tx_env: np.ndarray,
                 cw_us: float) -> np.ndarray:
        """Transmit ``tx_env`` (0/1 envelope at DAC rate) followed by
        ``cw_us`` of carrier; return the RX capture (command leak + any tag
        backscatter + noise) at ADC rate."""
        cfg = self.cfg
        from ..protocol import gen2

        self._expire_s1()
        if kind == "nak":
            # NAK returns an acknowledged tag to arbitrate WITHOUT toggling
            # its inventoried flag (Gen2 6.3.2.4) - the reader's tool for
            # keeping a failed-CRC tag in the current pass.
            for ts in self.tags:
                ts.pending_flip = False
        elif kind not in ("cw", "listen"):
            self._commit_flips()
        if kind == "select":
            # Gen2 6.3.2.12.1.1: every tag evaluates the mask against its
            # memory and applies the action's matching / non-matching
            # operation (table 6.29) to the targeted flag - SL (target
            # 100) or the inventoried flag of session S0-S3 (000-011).
            # Banks: EPC / TID / USER (RESERVED is not selectable);
            # Untraceable-hidden words (-1 sentinel) never match.
            tgt, action, membank, ptr, mask, truncate, crc_ok = (
                gen2.parse_select(bits))
            s_tgt = {v: k for k, v in gen2.SELECT_TARGET_S.items()}.get(tgt)
            if (crc_ok and membank != gen2.MEMBANK_RESERVED
                    and (tgt == gen2.SELECT_TARGET_SL or s_tgt is not None)
                    and action in gen2.SELECT_ACTIONS):
                for ts in self.tags:
                    mem = ts.tag.bank_bits(membank)
                    seg = (mem[ptr: ptr + mask.size]
                           if mem is not None else np.zeros(0, np.int64))
                    match = (seg.size == mask.size and np.all(seg >= 0)
                             and bool(np.array_equal(seg, mask)))
                    op = gen2.SELECT_ACTIONS[action][0 if match else 1]
                    if tgt == gen2.SELECT_TARGET_SL:
                        if op == "assert":
                            ts.sl = True
                        elif op == "deassert":
                            ts.sl = False
                        elif op == "negate":
                            ts.sl = not ts.sl
                        # Truncate=1 (Gen2 6.3.2.12.1.1): a matching tag's
                        # ACK reply carries only the EPC portion following
                        # the mask; persists until the next Select / power
                        # loss.
                        ts.truncate_from = (
                            ptr + mask.size
                            if (truncate and match
                                and membank == gen2.MEMBANK_EPC
                                and ptr >= 0x20) else None)
                    else:
                        # "assert" -> inventoried A (False), "deassert" ->
                        # B (True), per table 6.29's flag column.
                        if op == "assert":
                            ts.flags[s_tgt] = False
                        elif op == "deassert":
                            ts.flags[s_tgt] = True
                        elif op == "negate":
                            ts.flags[s_tgt] = not ts.flags[s_tgt]
                        if s_tgt == 1 and ts.flags[1]:
                            ts.s1_set_t = self._now_s()  # restart decay
        elif kind == "query":
            self.q = gen2.parse_query_q(bits)
            self._target = gen2.parse_query_target(bits)
            self._sel = gen2.parse_query_sel(bits)
            self._session = gen2.parse_query_session(bits)
            m = gen2.parse_query_m(bits)
            trext = gen2.parse_query_trext(bits)
            if (m, trext) != (self.link_cfg.miller_m, self.link_cfg.trext):
                self.link_cfg = dataclasses.replace(
                    self.cfg, miller_m=m, trext=trext)
            self._on_query(self.q, self._target, self._sel, self._session)
        elif kind == "query_adjust":
            self.q = int(np.clip(
                self.q + gen2.parse_query_adjust_updn(bits), 0, 15))
            self._on_query(self.q, getattr(self, "_target", 0),
                           getattr(self, "_sel", (0, 0)),
                           getattr(self, "_session", 0))
        elif kind == "query_rep":
            for ts in self.tags:
                if ts.slot > 0:
                    ts.slot -= 1
                ts.rn16 = None
        elif kind == "power_down":
            # Unpowered tags lose their volatile state.  Gen2 6.3.2.3
            # persistence: the S0 inventoried flag dies with power; S1
            # decays on its own timer and S2/S3 persist through short
            # power gaps - modeled as S1-S3 surviving the power-down.
            # SL is modeled volatile (its spec persistence matches S2/S3,
            # but the reference-era reader re-Selects after power-up and
            # the live loop does too - see LiveReader._send_select).
            for ts in self.tags:
                ts.slot = -1
                ts.rn16 = None
                ts.flags[0] = False
                ts.sl = False
                ts.pending_flip = False
                ts.truncate_from = None
                ts.response_buffer = None
        elif kind == "challenge":
            # Gen2 v2 6.3.2.12.3.10: broadcast.  Tags holding the selected
            # key precompute their crypto response into the ResponseBuffer
            # (retrieved later, post-singulation, via ReadBuffer).
            from ..protocol.crypto import parse_tam1_message

            immed, csi, message, crc_ok = gen2.parse_challenge(bits)
            if crc_ok:
                parsed = parse_tam1_message(message)
                for ts in self.tags:
                    ts.response_buffer = None
                    if parsed is not None and not ts.tag.killed:
                        ts.response_buffer = ts.tag.tam1_answer(
                            csi, parsed[0], parsed[1])
        # "cw": no protocol state changes - tags simply stay silent.

        cmd = (np.repeat(tx_env.astype(np.complex64), self.up)
               * self.leak * self._pol)
        if tx_env.size:
            if float(np.real(tx_env[-1])) < 0:
                self._pol = -self._pol     # PR-ASK: odd reversal count
        n_cw = int(round(cw_us * self.sp_us))
        if kind == "listen":
            # LBT sensing window: the reader's own TX is OFF, so the RX
            # is ambient only (other readers' carriers + noise) -
            # EN 302 208-style clear-channel assessment.
            cw = np.zeros(n_cw, dtype=np.complex64)
        else:
            cw = np.full(n_cw, self.leak * self._pol, dtype=np.complex64)

        # All reply synthesis below runs at the link the reader COMMANDED
        # in its last Query (M / TRext), which may differ from the
        # constructor config when the reader adapts its link rate.
        cfg = self.link_cfg

        replies = []

        def err(ts, name):
            """Queue an Annex-I error reply (no-op when error_replies is
            off - older-silicon silence)."""
            if self.error_replies:
                replies.append((ts, reply_chips(
                    cfg, gen2.error_reply_bits(name, ts.handle))))
        if kind in ("query", "query_rep", "query_adjust"):
            for ts in self.tags:
                ts.acked = False
                ts.handle = None
            for ts in self._responders():
                ts.rn16 = ts.tag.draw_rn16()
                replies.append((ts, reply_chips(cfg, ts.rn16)))
        elif kind == "req_rn":
            # Gen2 6.3.2.12.3.1: an Acknowledged tag whose RN16 matches
            # replies with a fresh 16-bit handle (-> Open state); an
            # Open-state tag whose HANDLE matches replies with a fresh
            # RN16 (the Write cover-code).
            rn, crc_ok = gen2.parse_req_rn(bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is not None and np.array_equal(
                            rn, ts.handle):
                        ts.cover_rn = ts.tag.draw_rn16()
                        replies.append((ts, reply_chips(
                            cfg, gen2.handle_reply_bits(ts.cover_rn))))
                    elif ts.acked and ts.rn16 is not None and np.array_equal(
                            rn, ts.rn16):
                        ts.handle = ts.tag.draw_rn16()
                        # Zero access password: Acknowledged -> Secured
                        # directly (Gen2 6.3.2.4 state diagram); otherwise
                        # -> Open, Secured only via the Access sequence.
                        ts.secured = ts.tag.access_pwd == 0
                        replies.append((ts, reply_chips(
                            cfg, gen2.handle_reply_bits(ts.handle))))
        elif kind == "read":
            # Gen2 6.3.2.12.3.2: the Open-state tag with this handle
            # backscatters header-0 + memory words + handle + CRC-16.
            membank, wordptr, wordcount, handle, crc_ok = gen2.parse_read(
                bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is not None and np.array_equal(
                            handle, ts.handle):
                        mem = ts.tag.bank_bits(membank, secured=ts.secured)
                        lo, hi = 16 * wordptr, 16 * (wordptr + wordcount)
                        # -1 sentinel = pwd-locked / Untraceable-hidden
                        # words unreadable in this state (Gen2 6.3.2.10).
                        if mem is None:
                            err(ts, "not supported")
                        elif hi > mem.size:
                            err(ts, "memory overrun")
                        elif np.any(mem[lo:hi] < 0):
                            err(ts, "memory locked")
                        else:
                            replies.append((ts, reply_chips(
                                cfg, gen2.read_reply_bits(
                                    mem[lo:hi], ts.handle))))
        elif kind == "write":
            # Gen2 6.3.2.12.3.3: data arrives cover-coded (XOR the RN16
            # from the preceding Req_RN(handle)); a successful write
            # backscatters header-0 + handle + CRC-16.
            membank, wordptr, cover, handle, crc_ok = gen2.parse_write(bits)
            if crc_ok:
                for ts in self.tags:
                    if (ts.handle is not None and ts.cover_rn is not None
                            and np.array_equal(handle, ts.handle)):
                        data = (cover + ts.cover_rn) % 2
                        ts.cover_rn = None      # cover RN is single-use
                        if ts.tag.write_word(membank, wordptr, data,
                                             secured=ts.secured):
                            replies.append((ts, reply_chips(
                                cfg, gen2.write_reply_bits(ts.handle))))
                        elif (not ts.tag.write_allowed(membank, ts.secured)
                              or (tuple(membank) == (1, 1)
                                  and wordptr < ts.tag.user_permalock.size
                                  and ts.tag.user_permalock[wordptr])):
                            err(ts, "memory locked")
                        else:
                            err(ts, "memory overrun")
        elif kind == "blockwrite":
            # Gen2 6.3.2.12.3.7: multi-word write, plaintext data; same
            # lock gating and success reply as Write.
            membank, wordptr, data, handle, crc_ok = gen2.parse_blockwrite(
                bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is not None and np.array_equal(
                            handle, ts.handle):
                        nw = data.size // 16
                        if not ts.tag.write_allowed(membank, ts.secured):
                            err(ts, "memory locked")
                            continue
                        ok = True
                        for w in range(nw):
                            ok = ok and ts.tag.write_word(
                                membank, wordptr + w,
                                data[16 * w: 16 * w + 16],
                                secured=ts.secured)
                        if ok:
                            replies.append((ts, reply_chips(
                                cfg, gen2.write_reply_bits(ts.handle))))
                        else:
                            err(ts, "memory overrun")
        elif kind == "blockerase":
            # Gen2 6.3.2.12.3.8: zero a word range; atomic, lock-gated like
            # Write (plus per-word USER permalocks); delayed success reply.
            membank, wordptr, wordcount, handle, crc_ok = gen2.parse_blockerase(
                bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is not None and np.array_equal(
                            handle, ts.handle):
                        if ts.tag.erase_words(membank, wordptr, wordcount,
                                              ts.secured):
                            replies.append((ts, reply_chips(
                                cfg, gen2.write_reply_bits(ts.handle))))
                        elif not ts.tag.write_allowed(membank, ts.secured):
                            err(ts, "memory locked")
                        elif (tuple(membank) == (1, 1) and np.any(
                                ts.tag.user_permalock[
                                    wordptr: wordptr + wordcount])):
                            err(ts, "memory locked")
                        else:
                            err(ts, "memory overrun")
        elif kind == "blockpermalock":
            # Gen2 6.3.2.12.3.9: Read/Lock=0 backscatters the permalock
            # status (Read-style reply); =1 permalocks masked blocks
            # (one-way, Secured state required - it is a lock mutation).
            (membank, read_lock, blockptr, blockrange, mask, handle,
             crc_ok) = gen2.parse_blockpermalock(bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is None or not np.array_equal(
                            handle, ts.handle):
                        continue
                    if not read_lock:
                        status = ts.tag.permalock_status(
                            membank, blockptr, blockrange)
                        if status is not None:
                            replies.append((ts, reply_chips(
                                cfg, gen2.read_reply_bits(status, ts.handle))))
                        else:
                            err(ts, "not supported")
                    elif not ts.secured:
                        err(ts, "insufficient privileges")
                    elif ts.tag.apply_block_permalock(membank, blockptr,
                                                      mask):
                        replies.append((ts, reply_chips(
                            cfg, gen2.write_reply_bits(ts.handle))))
                    else:
                        err(ts, "memory overrun")
        elif kind == "authenticate":
            # Gen2 v2 6.3.2.12.3.11 (SenRep=1): the handle-addressed tag
            # computes the crypto response and backscatters it immediately
            # as header-0 + response + handle + CRC-16.  The message's
            # AuthMethod field selects TAM1 (authenticate only) or TAM2
            # (authenticate + confidential memory read).  No key / wrong
            # suite / hidden words = silence.
            from ..protocol.crypto import (parse_tam1_message,
                                           parse_tam2_message)

            senrep, csi, message, handle, crc_ok = gen2.parse_authenticate(
                bits)
            if crc_ok and senrep == 1:
                t1 = parse_tam1_message(message)
                t2 = parse_tam2_message(message)
                for ts in self.tags:
                    if ts.handle is None or not np.array_equal(
                            handle, ts.handle):
                        continue
                    resp = None
                    if t1 is not None:
                        resp = ts.tag.tam1_answer(csi, t1[0], t1[1])
                        if resp is not None:
                            ts.sc_ctr = 0   # fresh AuthComm/SecureComm session
                    elif t2 is not None:
                        resp = ts.tag.tam2_answer(csi, *t2,
                                                  secured=ts.secured)
                    if resp is not None:
                        replies.append((ts, reply_chips(
                            cfg, gen2.read_reply_bits(resp, ts.handle))))
        elif kind == "readbuffer":
            # Gen2 v2 6.3.2.12.3.12: backscatter bits of the stored
            # (Challenge-precomputed) response; empty buffer / out-of-range
            # request = silence.
            bitptr, bitcount, handle, crc_ok = gen2.parse_readbuffer(bits)
            if crc_ok:
                for ts in self.tags:
                    if (ts.handle is not None
                            and np.array_equal(handle, ts.handle)
                            and ts.response_buffer is not None
                            and bitptr + bitcount <= ts.response_buffer.size):
                        replies.append((ts, reply_chips(
                            cfg, gen2.read_reply_bits(
                                ts.response_buffer[bitptr: bitptr + bitcount],
                                ts.handle))))
        elif kind == "auth_comm":
            # Gen2 v2 6.3.2.12.3.14: MAC-authenticated encapsulation - the
            # inner command travels in clear but a reader without the TAM1
            # session key cannot forge it (bad MAC = silence).
            from ..protocol import crypto

            inner, mac, handle, crc_ok = gen2.parse_auth_comm(bits)
            if crc_ok:
                for ts in self.tags:
                    if (ts.handle is None
                            or not np.array_equal(handle, ts.handle)
                            or ts.tag.session is None):
                        continue
                    key, chal, trnd = ts.tag.session
                    want = crypto.session_mac(key, chal, trnd, inner,
                                              ctr=ts.sc_ctr, direction=0)
                    ts.sc_ctr += 1
                    if not np.array_equal(mac, want):
                        continue               # forged/garbled: silence
                    r = self._exec_inner(ts, inner, err)
                    if r is None:
                        continue
                    op, words = r
                    reply = (gen2.read_reply_bits(words, ts.handle)
                             if op == "read"
                             else gen2.write_reply_bits(ts.handle))
                    replies.append((ts, reply_chips(cfg, reply)))
        elif kind == "secure_comm":
            # Gen2 v2 6.3.2.12.3.15: encrypted encapsulation - the inner
            # command and the secret part of the reply ride the TAM1
            # session's CTR keystream (confidential read/write: the data
            # never travels in clear, unlike Read / cover-coded Write).
            from ..protocol import crypto

            enc, handle, crc_ok = gen2.parse_secure_comm(bits)
            if crc_ok:
                for ts in self.tags:
                    if (ts.handle is None
                            or not np.array_equal(handle, ts.handle)
                            or ts.tag.session is None):
                        continue
                    key, chal, trnd = ts.tag.session
                    ks = crypto.session_keystream(
                        key, chal, trnd, ts.sc_ctr, enc.size, direction=0)
                    inner = (enc + ks) % 2
                    r = self._exec_inner(ts, inner, err)
                    if r is not None:
                        op, words = r
                        if op == "read":
                            ks2 = crypto.session_keystream(
                                key, chal, trnd, ts.sc_ctr, words.size,
                                direction=1)
                            reply = gen2.read_reply_bits(
                                (words + ks2) % 2, ts.handle)
                        else:
                            reply = gen2.write_reply_bits(ts.handle)
                        replies.append((ts, reply_chips(cfg, reply)))
                    ts.sc_ctr += 1
        elif kind == "access":
            # Gen2 6.3.2.12.3.6: two cover-coded password halves (MSB half
            # first); each valid half is echoed with the handle, the second
            # moves the tag Open -> Secured.  A wrong half silences the tag
            # and resets the sequence.
            cover_half, handle, crc_ok = gen2.parse_access(bits)
            if crc_ok:
                for ts in self.tags:
                    if (ts.handle is not None and ts.cover_rn is not None
                            and np.array_equal(handle, ts.handle)):
                        half = (cover_half + ts.cover_rn) % 2
                        ts.cover_rn = None
                        hi, lo = gen2.pwd_halves(ts.tag.access_pwd)
                        want = hi if ts.access_step == 0 else lo
                        if np.array_equal(half, want):
                            if ts.access_step == 1:
                                ts.secured = True
                            ts.access_step += 1
                            replies.append((ts, reply_chips(
                                cfg, gen2.handle_reply_bits(ts.handle))))
                        else:
                            ts.access_step = 0
        elif kind == "kill":
            # Gen2 6.3.2.12.3.4: two cover-coded kill-password halves; the
            # second valid half permanently silences the tag (delayed
            # header-0 + handle + CRC reply).  A zero kill password
            # disables the command entirely (the tag shall not execute it).
            cover_half, rfu, handle, crc_ok = gen2.parse_kill(bits)
            if crc_ok:
                for ts in self.tags:
                    if (ts.handle is not None and ts.cover_rn is not None
                            and np.array_equal(handle, ts.handle)
                            and ts.tag.kill_pwd != 0):
                        half = (cover_half + ts.cover_rn) % 2
                        ts.cover_rn = None
                        hi, lo = gen2.pwd_halves(ts.tag.kill_pwd)
                        if ts.kill_step == 0:
                            if np.array_equal(half, hi):
                                ts.kill_step = 1
                                replies.append((ts, reply_chips(
                                    cfg, gen2.handle_reply_bits(ts.handle))))
                        elif np.array_equal(half, lo):
                            replies.append((ts, reply_chips(
                                cfg, gen2.write_reply_bits(ts.handle))))
                            ts.tag.killed = True
                            ts.slot = -1
                            ts.acked = False
                            ts.handle = None
                            ts.pending_flip = False
                        else:
                            ts.kill_step = 0
        elif kind == "keyupdate":
            # Gen2 v2 shape + ISO 29167-10 key provisioning: Secured state
            # required; the new key travels encrypted under the current
            # key; delayed Write-style success reply after installation.
            csi, key_id, enc, handle, crc_ok = gen2.parse_keyupdate(bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is not None and np.array_equal(
                            handle, ts.handle):
                        if not ts.secured:
                            err(ts, "insufficient privileges")
                        elif ts.tag.install_key(csi, key_id, enc):
                            replies.append((ts, reply_chips(
                                cfg, gen2.write_reply_bits(ts.handle))))
                        else:
                            err(ts, "crypto suite")
        elif kind == "untraceable":
            # Gen2 v2 6.3.2.12.3.13: Secured state required (it mutates
            # privacy state); delayed Write-style success reply.
            (u, epc_words, tid, hide_user, range_, handle,
             crc_ok) = gen2.parse_untraceable(bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is not None and np.array_equal(
                            handle, ts.handle):
                        if not ts.secured:
                            err(ts, "insufficient privileges")
                        elif ts.tag.apply_untraceable(
                                u, epc_words, tid, hide_user, range_):
                            replies.append((ts, reply_chips(
                                cfg, gen2.write_reply_bits(ts.handle))))
                        else:
                            err(ts, "other")
        elif kind == "lock":
            # Gen2 6.3.2.12.3.5: Secured state only; permalocked fields
            # reject changes (no reply); success reply mirrors Write's.
            payload, handle, crc_ok = gen2.parse_lock(bits)
            if crc_ok:
                for ts in self.tags:
                    if ts.handle is not None and np.array_equal(
                            handle, ts.handle):
                        if not ts.secured:
                            err(ts, "insufficient privileges")
                        elif ts.tag.apply_lock(payload):
                            replies.append((ts, reply_chips(
                                cfg, gen2.write_reply_bits(ts.handle))))
                        else:
                            err(ts, "memory locked")   # permalocked field
        elif kind == "ack":
            acked = np.asarray(bits[2:18], dtype=np.int64)
            for ts in self._responders():
                if ts.rn16 is not None and np.array_equal(acked, ts.rn16):
                    if ts.truncate_from is not None:
                        # Truncated reply (Gen2 6.3.2.12.1.1): header-0 +
                        # the EPC following the mask + CRC-16 over the
                        # backscattered bits.
                        bank = ts.tag.epc_bank_bits()
                        rem = bank[ts.truncate_from:]
                        body = np.concatenate(
                            [np.zeros(1, np.int64), rem])
                        fr = np.concatenate(
                            [body, gen2._crc16_any(body)])
                        replies.append((ts, reply_chips(cfg, fr)))
                    else:
                        replies.append((ts, reply_chips(
                            cfg, ts.tag.epc_frame_bits())))
                    ts.acked = True      # Acknowledged state: Req_RN valid
                    if self.session_ab:
                        # Valid ACK: this round's session flag toggles at
                        # the next non-NAK command (the tag believes it
                        # was read even if the reader's EPC CRC later
                        # fails).
                        ts.pending_flip = True
                        ts.flip_session = getattr(self, "_session", 0)
                # Slot is over either way: acked tags are inventoried,
                # un-acked (collided / mis-decoded) tags back off to the
                # next Query round.
                ts.slot = -1

        for ts, chips in replies:
            t_s = (self.t_samples + cmd.size) / cfg.adc_rate
            # The backscatter is a reflection of the (possibly
            # phase-reversed) carrier, so the tag's channel phasor rides
            # the current polarity; the per-frame h_est absorbs it.
            superpose_reply(cw, chips, self.tag_t1_us,
                            ts.tag.channel_phasor(cfg, t_s, self.carrier_hz)
                            * complex(self._pol),
                            ts.tag.chip_us(cfg), self.sp_us, cfg.adc_rate,
                            ts.tag.cfo_hz, ts.tag.amp_ramp)

        rx = np.concatenate([cmd, cw])
        for f_hz, dbc in self.interferers.items():
            off = float(f_hz) - self.carrier_hz
            if abs(off) >= cfg.adc_rate / 2:
                continue   # outside the RX bandwidth after re-tuning away
            amp = np.abs(self.leak) * 10.0 ** (dbc / 20.0)
            n0 = self.t_samples + np.arange(rx.size)
            rx = rx + (amp * np.exp(
                2j * np.pi * off * n0 / cfg.adc_rate)).astype(np.complex64)
        self.t_samples += rx.size
        if self.noise > 0:
            rx = rx + (
                self.rng.normal(0, self.noise / np.sqrt(2), rx.size)
                + 1j * self.rng.normal(0, self.noise / np.sqrt(2), rx.size)
            ).astype(np.complex64)
        return rx.astype(np.complex64)
