"""Closed-loop live reader: TX synthesis driven by decoded replies.

The real-time counterpart of the reference application (its non-DEBUG mode,
``apps/reader.py:82-96``): the reader transmits Query/QueryRep, decodes the
RN16 from the returning samples, transmits an ACK *containing the decoded
bits*, and decodes the EPC - one slot at a time, with decode results feeding
back into what gets transmitted.  The batch decoder can never demonstrate
this loop (pre-recorded traces already contain the answers); here a wrong
RN16 decode silences the tag (see sim/channel.py), so every EPC read proves
the loop.

FSM parity with the reference's 10-state transmit machine
(``reader_impl.cc:200-380``):

* START power-up CW and POWER_DOWN (2 ms of zeros, ``reader_impl.cc:226-230``)
  are emitted (power-down behind ``power_down_every``; the reference builds
  the waveform but only reaches the state via commented-out decoder
  transitions, ``tag_decoder_impl.cc:280,337,374``);
* SEND_QUERY / SEND_ACK+SEND_CW / SEND_QUERY_REP exactly as before;
* SEND_QUERY_ADJUST with a live Annex-D Q controller (``adaptive=True``):
  Qfp += C on a collision slot, -= C on an empty slot, QueryAdjust issued
  when round(Qfp) changes - the reference ships the synthesis
  (``reader_impl.cc:156-162``) but pins FIXED_Q;
* SEND_NAK_QR / SEND_NAK_Q (``reader_impl.cc:233-249``) behind
  ``nak_on_fail``: a failed EPC CRC triggers a NAK before the next
  Query/QueryRep (the reference's transition is commented out,
  ``tag_decoder_impl.cc:376,381``).

Slot classification (empty / single / collision) reuses the batch
classifier's thresholds on the same live-measured signals (reply-window
energy vs the gate's CW noise estimate, decision margin, |h_est|^2).

Per-slot decoding reuses the batch primitives on small blocks: inline FIR,
the block-parallel gate with a carried RX context tail, and the per-frame
sync/FM0/CRC stack.  ``LiveStats.slot_latency_s`` records the wall time of
every full slot (TX -> decode -> ACK -> decode); see ``latency_summary``.

Radio I/O is abstracted behind a ``channel.exchange(kind, bits, tx_env,
cw_us)`` callable; `sim.channel.SimTagChannel` provides the simulated air
interface, and `io.radio` provides a UHD-style adapter shape for real
hardware.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np

from ..config import ReaderConfig
from ..dsp.collision import _check_tf32
from ..protocol import gen2
from ..tx.pie import PieEncoder

# Re-exports: the public surface predates the round-4 decomposition into
# live_stats / live_decode / live_rf / live_access; importers keep using
# this module as the single entry point.
from .live_access import AccessOpsMixin
from .live_decode import SlotDecodeMixin, _RnResult, _window_decoder  # noqa: F401
from .live_rf import ETSI_LOWER_MHZ, RfManagementMixin, default_link_profiles  # noqa: F401
from .live_stats import LiveStats
from .inventory import resolve_device

# The reference logs every FSM transition through log4cpp's debug logger
# (GR_LOG_INFO(d_debug_logger, ...), reader_impl.cc:219-358); this is the
# Python-logging analogue, silent unless the application enables it.
_log = logging.getLogger("gen2_rfid_tpu_torch.live")


class LiveReader(AccessOpsMixin, RfManagementMixin, SlotDecodeMixin):
    """Drives inventory rounds over an interactive channel.

    ``adaptive``: run a Q controller (QueryAdjust when round(Qfp) moves).
    ``q_mode`` selects it:

    * ``"annexd"`` — the Gen2 Annex-D walk the reference ships synthesis
      for (reader_impl.cc:156-162): Qfp += q_c on a collision slot,
      -= q_c on an empty slot.  Blind to collision *multiplicity*, so it
      climbs one fractional step per collided slot and oscillates at the
      optimum.
    * ``"backlog"`` — population-estimating controller (new capability,
      enabled by SIC): each slot yields an occupancy observation k_hat
      (0 empty / 1 single / 2.39 collision — E[colliders | collision] at
      the Aloha optimum, Schoute 1983).  At each round boundary the
      population estimate n_hat = mean(k_hat) * 2^Q (blended 50/50 with
      the carried estimate) sets Qfp = log2(n_hat) directly, so Q
      *jumps* to the right value instead of walking; mid-round
      QueryAdjust fires only on decisive under-sizing (qfp - q >= 1.5,
      i.e. collisions so dense the round is pointless to finish —
      aborting a round re-randomizes every tag, so weak evidence must
      never do it).  With ``sic=True`` the SIC pass-1 cancel ratio
      refines k_hat: a "collision" verdict whose window is ~fully
      explained by one template (cancel > 0.985; measured split:
      singles >= 0.992, true collisions <= 0.975) downgrades to 1.5,
      and a "single" verdict with substantial unexplained energy
      upgrades to 2.39 (phase-aligned collisions the margin classifier
      misses).

    ``nak_on_fail``: transmit a NAK after a failed EPC CRC on an occupied
    slot (SEND_NAK_QR/Q parity).  In session inventory a NAK also keeps
    the failed tag in the current pass: it returns the tag to arbitrate
    WITHOUT toggling its inventoried flag (Gen2 6.3.2.4).
    ``power_down_every``: emit POWER_DOWN + START CW before every Nth
    Query round (0 = never, the reference's effective behavior).
    ``target_ab``: session inventory (new capability; the reference pins
    TARGET=0, global_vars.h:121).  Queries carry the reader's current
    target flag; singulated tags toggle their inventoried flag and drop
    out of the pass, and when a full Query round comes back empty the
    reader flips its target to inventory the other population — each tag
    is read exactly once per pass instead of once per round.  Requires a
    channel with session semantics (``SimTagChannel(session_ab=True)``).
    ``select_mask``: (mask_bits, pointer) — transmit a Gen2 Select
    (6.3.2.12.1.1; mandatory in the spec, absent from the reference) at
    power-up and after every power-down, asserting SL on tags whose EPC
    bank matches ``mask_bits`` at bit address ``pointer`` (0x20 = EPC
    field start); Queries then carry Sel=SL so only the masked
    sub-population is inventoried.  ``select_bank`` ("epc"/"tid"/"user"),
    ``select_target`` ("sl", or "s0".."s3" to pre-position a session's
    inventoried flags instead — pair with ``target_ab``), and
    ``select_action`` (0-7, table 6.29) generalize it; Untraceable-hidden
    words never match.
    ``access_read``: (wordptr, wordcount[, bank]) — after every correct
    EPC, run the Gen2 access sequence (6.3.2.12.3; the reference never
    leaves inventory): Req_RN(RN16) → CRC-checked 16-bit handle →
    Read(bank, wordptr, wordcount) → header-0 + data words + handle echo
    + CRC-16, all verified.  Read words land in
    ``LiveStats.read_words[tag_id]``.
    ``access_write``: (wordptr, word_bits16[, bank]) — Write one word
    (default USER bank; EPC-bank words >= 2 re-label the tag): a second
    Req_RN(handle) fetches the cover-code RN16, the data travels XOR'd
    with it, and the tag's header-0 + handle + CRC-16 success reply is
    verified.  Combine with ``access_read`` for write-then-read-back.
    ``access_pwd``: 32-bit password — run the Gen2 Access sequence
    (6.3.2.12.3.6) after the handle: two cover-coded halves, each echoed
    with the handle; success moves the tag to Secured, unlocking
    password-locked reads/writes and enabling Lock.
    ``lock``: a 20-bit Lock payload (``gen2.lock_payload``) transmitted
    from the Secured state (6.3.2.12.3.5); the header-0 + handle + CRC
    success reply is verified.
    ``block_write``: (wordptr, data_bits[, bank]) — one BlockWrite of
    ``len(data_bits)//16`` words, plaintext data (6.3.2.12.3.7).
    ``kill_pwd``: 32-bit kill password — after each correct EPC, transmit
    the two-step Kill sequence (6.3.2.12.3.4); on the second success reply
    the tag is dead and never answers again.
    ``authenticate``: (key_id, key16bytes) — Gen2 v2 cryptographic tag
    authentication (6.3.2.12.3.11 + ISO 29167-10 AES-128 TAM1): after each
    correct EPC and handle, the reader draws a fresh 96-bit challenge,
    transmits Authenticate (SenRep=1), decodes the 128-bit immediate
    response, decrypts it and verifies the embedded challenge — proof the
    tag holds the key, replay-proof by construction.
    ``challenge_auth``: (key_id, key16bytes) — the broadcast variant
    (6.3.2.12.3.10): one Challenge before inventory lets every tag
    precompute its response; after singulation a ReadBuffer (6.3.2.12.3.12)
    fetches and verifies it, amortizing the crypto across the population.
    ``untraceable``: kwargs dict for ``gen2.untraceable_bits`` (e.g.
    ``dict(epc_words=2, tid="all", range_="reduced")``) — the Gen2 v2
    privacy command (6.3.2.12.3.13), issued from the Secured state after
    each correct EPC: the tag thereafter exposes a truncated EPC, hides
    TID/USER memory, and/or answers at reduced backscatter power.
    ``key_update``: (key_id, old_key16, new_key16) — over-the-air key
    provisioning (Gen2 v2 KeyUpdate shape + ISO 29167-10): the new key
    travels AES-encrypted under the current key, from the Secured state;
    the delayed success reply is verified.  Combine with ``authenticate``
    under the new key on a later pass to prove installation.
    ``authenticate_read``: (key_id, key16, wordptr, n_blocks[, bank]) —
    TAM2 authenticated *confidential* read: one Authenticate both proves
    the key and returns ``n_blocks`` 128-bit blocks of tag memory
    CBC-encrypted under it (IV = the tag-random auth block, so repeated
    reads of the same words never produce the same ciphertext).  Decrypted
    words land in ``LiveStats.secure_read_words[tag_id]``.
    """

    #: E[tags per collided slot] at the framed-Aloha optimum (Schoute).
    SCHOUTE_K = 2.39
    #: SIC pass-1 cancel-ratio split between one-tag and multi-tag windows.
    SIC_MULTI_CANCEL = 0.985

    def __init__(
        self,
        cfg: ReaderConfig,
        *,
        adaptive: bool = False,
        q_init: Optional[int] = None,
        q_c: float = 0.35,
        q_mode: str = "annexd",
        nak_on_fail: bool = False,
        power_down_every: int = 0,
        sic: bool = False,
        target_ab: bool = False,
        select_mask=None,
        select_bank: str = "epc",
        select_target: str = "sl",
        select_action: int = 0,
        select_truncate: bool = False,
        access_read=None,
        access_write=None,
        access_pwd: Optional[int] = None,
        lock=None,
        block_write=None,
        block_erase=None,
        block_permalock=None,
        kill_pwd: Optional[int] = None,
        authenticate=None,
        challenge_auth=None,
        untraceable=None,
        key_update=None,
        authenticate_read=None,
        secure_read=None,
        secure_write=None,
        auth_comm_write=None,
        hop_mhz=None,
        hop_every: int = 1,
        link_profiles=None,
        link_down_after: int = 1,
        link_up_after: int = 4,
        link_probe: bool = True,
        lbt_mhz=None,
        lbt_listen_us: float = 200.0,
        lbt_margin_db: float = 6.0,
        lbt_floor_min: float = 1e-9,
        device=None,
    ):
        assert q_mode in ("annexd", "backlog")
        # Every window decodes on ``device``, the CUDA card unless it says
        # otherwise; without one this raises (resolve_device).
        self.device = resolve_device(device)
        if sic:
            # SIC's contractions refuse TF32 on CUDA: refuse it up front.
            _check_tf32(self.device)
        self.target_ab = target_ab
        self.target = int(cfg.target)
        self.select_mask = select_mask
        # Select generality (Gen2 6.3.2.12.1.1): bank (epc/tid/user),
        # target ("sl" or "s0".."s3" = a session's inventoried flag) and
        # action (0-7, table 6.29).  Queries carry Sel=SL only when the
        # Select targets SL; session-flag Selects pre-position the A/B
        # populations instead.
        self.select_bank = select_bank
        self.select_target = select_target
        self.select_action = select_action
        self._sel = (gen2.SEL_SL
                     if select_mask is not None and select_target == "sl"
                     else None)
        # Select Truncate=1 (Gen2 6.3.2.12.1.1): ACKed tags backscatter
        # only the EPC following the mask (+ header-0 + CRC-16) - the
        # air-time saving for long masks.  The reader derives the reply
        # length from its own mask and the population EPC length
        # (cfg.epc_bits), so the decode window is static.
        self.select_truncate = select_truncate
        self._trunc_nb = None
        if select_truncate:
            assert select_mask is not None, "truncate needs a Select mask"
            mask, pointer = select_mask
            epc_len = 16 * ((cfg.epc_bits - 33) // 16)
            rem = (0x20 + epc_len) - (pointer + len(mask))
            assert rem >= 8, "mask leaves too little EPC to identify a tag"
            self._trunc_nb = 1 + rem + 16      # header + remainder + CRC
        self.access_read = access_read
        self.access_write = access_write
        self.access_pwd = access_pwd
        self.lock = lock
        self.block_write = block_write
        # (wordptr, wordcount[, bank]): BlockErase after each correct EPC.
        self.block_erase = block_erase
        # (blockptr, mask_bits | None): BlockPermalock - None mask reads
        # the permalock status, a mask permalocks those blocks (Secured).
        self.block_permalock = block_permalock
        self.kill_pwd = kill_pwd
        # Gen2 v2 authentication: (key_id, 16-byte AES-128 key).
        self.authenticate = authenticate
        self.challenge_auth = challenge_auth
        # Gen2 v2 Untraceable kwargs (needs Secured: pair with access_pwd
        # unless the tag's access password is zero).
        self.untraceable = untraceable
        # (key_id, old_key, new_key) over-the-air key provisioning.
        self.key_update = key_update
        # (key_id, key, wordptr, n_blocks[, bank]) TAM2 confidential read.
        self.authenticate_read = authenticate_read
        # Gen2 v2 AuthComm/SecureComm encapsulation (6.3.2.12.3.14-15):
        # one TAM1 exchange establishes the session, then
        #   secure_read  = (key_id, key, wordptr, wordcount[, bank]) -
        #     encrypted Read: the words never travel in clear;
        #   secure_write = (key_id, key, wordptr, data_bits16[, bank]) -
        #     encrypted Write (supersedes RN16 cover-coding);
        #   auth_comm_write = (key_id, key, wordptr, data_bits16[, bank]) -
        #     MAC-authenticated cleartext Write (a keyless rogue reader
        #     cannot forge it).
        # When several are set they share the first option's session.
        self.secure_read = secure_read
        self.secure_write = secure_write
        self.auth_comm_write = auth_comm_write
        # FCC frequency hopping: cycle these carriers (MHz), retuning the
        # channel every ``hop_every`` Query rounds.  A hopping session's
        # per-read phases span multiple carriers -> live PDOA range
        # (``LiveStats.range_estimate``).  The FCC plan is 50 channels /
        # 500 kHz in 902.75-927.25; any >= 2 distinct carriers work.
        self.hop_mhz = list(hop_mhz) if hop_mhz else None
        self.hop_every = max(1, int(hop_every))
        self._carrier_hz = float(cfg.freq_hz)
        self._challenge = None       # outstanding broadcast challenge bits
        self._auth_rng = np.random.default_rng(0x29167)
        self.cfg = cfg
        self.enc = PieEncoder(cfg)
        self.stats = LiveStats()
        self.adaptive = adaptive
        self.q_mode = q_mode
        self._n_est = 1.0        # carried population estimate (backlog)
        self._round_k = 0.0      # sum of k_hat over this round's slots
        self._round_slots = 0
        # Capture-style collision recovery (dsp/collision.py, FM0 and
        # Miller-M incl. TRext pilots): the SIC decoder's pass 1 equals
        # the plain RN16 decode, so on a collided slot the ACK carries
        # the dominant tag's exact RN16 and its EPC is read instead of
        # the slot being lost.
        self.sic = sic
        self.q = cfg.fixed_q if q_init is None else q_init
        self.qfp = float(self.q)
        self.q_c = q_c
        self.nak_on_fail = nak_on_fail
        self.power_down_every = power_down_every
        # Link-rate adaptation (new capability; Gen2 readers own the M /
        # TRext fields of every Query, 6.3.2.12.1, so the reply encoding
        # is a per-round reader decision - commercial readers' "autoset").
        # ``link_profiles`` is an ordered ladder, fastest link first, most
        # robust (highest Miller M) last; all profiles share the radio
        # rates (adc/dac) and differ in miller_m / decim / trext.  A round
        # with occupied slots decoding < 50% steps down the ladder after
        # ``link_down_after`` consecutive such rounds; ``link_up_after``
        # consecutive fully-clean rounds step back up.  The SimTagChannel
        # honors the commanded M per Query (sim/channel.py link_cfg), so
        # switches take effect mid-inventory with no channel restart.
        self.link_profiles = list(link_profiles) if link_profiles else None
        self._link_idx = 0
        self._link_bad = 0
        self._link_clean = 0
        self.link_down_after = max(1, int(link_down_after))
        self.link_up_after = max(1, int(link_up_after))
        self.link_probe = bool(link_probe)
        # Listen-before-talk over a channel plan (new capability; ETSI
        # EN 302 208-style clear-channel assessment - see ETSI_LOWER_MHZ).
        # Before each Query round the reader listens with its TX off; a
        # channel more than ``lbt_margin_db`` above the plan's measured
        # noise floor (surveyed once at start) is busy, and the reader
        # moves to the next channel of the plan instead of transmitting
        # over the other occupant.
        self.lbt_mhz = list(lbt_mhz) if lbt_mhz else None
        self.lbt_listen_us = float(lbt_listen_us)
        self.lbt_margin_db = float(lbt_margin_db)
        # Absolute lower bound on the measured noise floor: in a clean
        # (noiseless-sim / high-gain-squelched) environment the measured
        # floor can be ~0, which would make every nonzero channel read
        # busy; and the per-channel history keeps the floor fresh when the
        # ambient level or RX gain changes mid-inventory (a one-shot
        # survey would go stale).
        self.lbt_floor_min = float(lbt_floor_min)
        self._lbt_hist: dict = {}
        self._lbt_idx = 0
        if self.lbt_mhz:
            assert hop_mhz is None, "LBT and fixed hopping are exclusive"
            diffs = [abs(f * 1e6 - cfg.freq_hz) for f in self.lbt_mhz]
            self._lbt_idx = int(np.argmin(diffs))
        if self.link_profiles:
            rates = {(p.adc_rate, p.dac_rate) for p in self.link_profiles}
            assert len(rates) == 1, "link profiles must share radio rates"
            assert cfg in self.link_profiles, (
                "cfg must be one of link_profiles (the starting rung)")
            self._link_idx = self.link_profiles.index(cfg)
        # RX context carried between exchanges so the gate's moving average
        # and DC state are warm when each reply window arrives.
        n_taps = int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)
        self._ctx_len = (cfg.win_length + cfg.n_samples_t1 + 64) * cfg.decim + n_taps
        self._block_shapes = set()   # distinct (len, mode) decode shapes
        self._reset_ctx()

    # ---- the closed loop ----

    def run_inventory(self, channel, n_rounds: int) -> LiveStats:
        """Run until ``n_rounds`` round-starting commands (Query or
        QueryAdjust) have been issued and their slots walked."""
        cfg = self.cfg
        st = self.stats
        empty = np.zeros(0, np.int64)

        self._t0_run = time.perf_counter()
        # START: power-up CW before the first Query (reader_impl.cc:219-224).
        channel.exchange("cw", empty, self.enc.cw_ack, 0.0)
        self._send_select(channel)
        self._send_challenge(channel)
        self._reset_ctx()

        rounds_issued = 0
        slots_left = 0
        slot_no = 0
        next_cmd = "query"
        while True:
            t0 = time.perf_counter()
            # Re-bind per iteration: link adaptation may have switched
            # self.cfg (and the TX encoder) at the last round boundary.
            cfg = self.cfg
            cw_q = float(cfg.t1_us + cfg.t2_us + cfg.rn16_us)
            cw_a = float(3 * cfg.t1_us + cfg.t2_us + cfg.epc_us)
            # ---- command opening this slot ----
            if next_cmd in ("query", "query_adjust"):
                if rounds_issued >= n_rounds:
                    break
                rounds_issued += 1
                if next_cmd == "query":
                    if (self.power_down_every
                            and rounds_issued > 1
                            and (rounds_issued - 1) % self.power_down_every == 0):
                        # POWER_DOWN (2 ms of zeros) then START CW
                        # (reader_impl.cc:226-230 -> 219-224).
                        channel.exchange("power_down", empty,
                                         np.zeros(cfg.n_p_down_tx, np.float32),
                                         0.0)
                        channel.exchange("cw", empty, self.enc.cw_ack, 0.0)
                        # SL / ResponseBuffer do not survive power loss:
                        # re-select, re-challenge.
                        self._send_select(channel)
                        self._send_challenge(channel)
                        self._reset_ctx()
                    # Clear-channel assessment before transmitting the
                    # round (no-op without lbt_mhz).
                    self._lbt_check(channel)
                    if (self.hop_mhz
                            and (rounds_issued - 1) % self.hop_every == 0):
                        # FCC dwell boundary: hop to the next carrier.
                        k = ((rounds_issued - 1) // self.hop_every) % len(
                            self.hop_mhz)
                        self._carrier_hz = self.hop_mhz[k] * 1e6
                        if hasattr(channel, "retune"):
                            channel.retune(self._carrier_hz)
                        _log.debug("HOP | %.2f MHz", self.hop_mhz[k])
                    kind, bits = "query", gen2.query_bits(
                        cfg, self.q, self.target, self._sel)
                    tx = self.enc.query(self.q, self.target, self._sel)
                else:
                    updn = (+1 if round(self.qfp) > self.q
                            else (-1 if round(self.qfp) < self.q else 0))
                    self.q = int(np.clip(round(self.qfp), 0, 15))
                    kind, bits = "query_adjust", gen2.query_adjust_bits(cfg, updn)
                    tx = self.enc.query_adjust(updn)
                    st.n_qadjust += 1
                slots_left = 2**self.q
                slot_no = 0
                self._round_k = 0.0
                self._round_slots = 0
                round_occupied = 0
                round_epc_ok = 0
                st.q_trace.append(self.q)
            else:
                kind, bits = "query_rep", gen2.query_rep_bits(cfg)
                tx = self.enc.query_rep()
                slot_no += 1
            _log.debug("%s | round %d slot %d q=%d", kind.upper(),
                       st.cur_round, st.cur_slot, self.q)
            rx = channel.exchange(kind, bits, tx, cw_q)
            st.n_queries += 1

            # ---- RN16 decode + slot classification ----
            rn = self._decode_window(rx, "sic" if self.sic else "rn16")
            from .inventory import SLOT_COLLISION, SLOT_EMPTY

            slot_state = self._classify(rn)
            if rn is None:
                st.n_no_rn16 += 1
                rn16 = np.zeros(16, np.int64)
            else:
                rn16 = rn.bits
            if slot_state != SLOT_EMPTY:
                round_occupied += 1
            if slot_state == SLOT_EMPTY:
                st.n_empty_slots += 1
            elif slot_state == SLOT_COLLISION:
                st.n_collision_slots += 1
                if self.sic and rn is not None and rn.bits2 is not None:
                    st.sic_rn16_pairs.append((rn.bits, rn.bits2))
            else:
                st.n_single_slots += 1

            # ---- ACK always follows (reference closed-loop behavior:
            # the RN16 branch always yields 16 bits). ----
            _log.debug("SEND ACK | rn16=%s", "".join(map(str, rn16)))
            ack = gen2.ack_bits(np.asarray(rn16))
            epc_ok = False
            out = None
            if self._trunc_nb:
                # Truncated reply (Select Truncate=1): header-0 +
                # EPC-after-mask + CRC-16, in a correspondingly shorter CW
                # (the feature's air-time win).
                nb = self._trunc_nb
                cw_t = float(3 * cfg.t1_us + cfg.t2_us
                             + (nb + 1 + cfg.effective_preamble_bits)
                             * cfg.tag_bit_us)
                rx2 = channel.exchange("ack", ack, self.enc.ack(rn16), cw_t)
                tout = self._decode_window(rx2, f"acc:{nb}")
                if (tout is not None and tout[0] == 0
                        and np.array_equal(gen2._crc16_any(tout[: nb - 16]),
                                           tout[nb - 16:])):
                    epc_ok = True
                    st.n_epc_correct += 1
                    st.n_truncated_reads += 1
                    # The ID byte (last EPC byte) always rides the
                    # remainder (asserted >= 8 bits at construction).
                    tid = int("".join(map(str, tout[nb - 24: nb - 16])), 2)
                    st.tag_reads[tid] += 1
                    _log.debug("EPC (truncated) DECODED | tag %#x", tid)
                    if self._wants_access:
                        self._access_sequence(channel, rn16, tid)
            else:
                rx2 = channel.exchange("ack", ack, self.enc.ack(rn16), cw_a)
                out = self._decode_window(
                    rx2, "epc_sic" if self.sic else "epc")
            if out is not None:
                h_read = None
                if self.sic:
                    epc_bits, epc_ok, epc_bits2, epc_ok2 = out
                else:
                    epc_bits, epc_ok, h_read = out
                    epc_bits2, epc_ok2 = None, False
                if epc_ok:
                    st.n_epc_correct += 1
                    # PC-length-aware id (== bits[104:112] for 96-bit EPCs).
                    tid = gen2.parse_epc_frame(epc_bits)[2]
                    if h_read is not None:
                        # Per-read phase/RSSI observable at the channel's
                        # signal clock (SimTagChannel.t_samples; wall clock
                        # for radio adapters without one).
                        tsmp = getattr(channel, "t_samples", None)
                        t_s = ((tsmp - len(rx2)) / cfg.adc_rate
                               if tsmp is not None
                               else time.perf_counter() - self._t0_run)
                        st.phase_reads.setdefault(tid, []).append(
                            (t_s, float(np.angle(h_read)),
                             float(10 * np.log10(max(abs(h_read) ** 2,
                                                     1e-30))),
                             self._carrier_hz))
                    st.tag_reads[tid] += 1
                    _log.debug("EPC CORRECTLY DECODED | tag %#x", tid)
                    if slot_state == SLOT_COLLISION and self.sic:
                        st.n_sic_recovered += 1
                    if self._wants_access:
                        self._access_sequence(channel, rn16, tid)
                # EPC-window SIC: two tags that drew the SAME RN16 both
                # match the ACK and answer superposed; the residual's frame
                # self-validates via CRC-16 (dsp/collision.py::epc_sic).
                if (epc_ok2 and epc_bits2 is not None
                        and (not epc_ok
                             or not np.array_equal(epc_bits2, epc_bits))):
                    st.n_epc_correct += 1
                    st.n_epc_sic_second += 1
                    tid2 = gen2.parse_epc_frame(epc_bits2)[2]
                    st.tag_reads[tid2] += 1
                    _log.debug("EPC (SIC residual) DECODED | tag %#x", tid2)
                    epc_ok = True
            if not epc_ok and self.nak_on_fail and slot_state != SLOT_EMPTY:
                # SEND_NAK_QR/Q: NAK + CW before the next Query/QueryRep
                # (reader_impl.cc:233-249).
                channel.exchange("nak", gen2.nak_bits(), self.enc.nak(),
                                 float(cfg.cw_us))
                st.n_nak += 1

            # ---- bookkeeping + Annex-D Q update ----
            round_epc_ok += int(epc_ok)
            st.cur_slot += 1
            if st.cur_slot > 2**self.q:
                st.cur_slot = 1
                st.cur_round += 1
            if self.adaptive:
                if self.q_mode == "backlog":
                    sic_multi = (self.sic and rn is not None
                                 and rn.cancel_ratio < self.SIC_MULTI_CANCEL)
                    if slot_state == SLOT_EMPTY:
                        k_hat = 0.0
                    elif slot_state == SLOT_COLLISION or sic_multi:
                        k_hat = (self.SCHOUTE_K
                                 if sic_multi or not self.sic else 1.5)
                    else:
                        k_hat = 1.0
                    self._round_k += k_hat
                    self._round_slots += 1
                    n_hat = (self._round_k / self._round_slots
                             * float(2 ** self.q))
                    if slots_left <= 1:
                        # Round boundary: full-round evidence, decide
                        # freely (50/50 blend with the carried estimate).
                        self._n_est = 0.5 * self._n_est + 0.5 * n_hat
                        self.qfp = float(np.clip(
                            np.log2(max(self._n_est, 1.0)), 0.0, 15.0))
                    else:
                        # Mid-round: abort only on decisive under-sizing.
                        qfp = float(np.clip(
                            np.log2(max(n_hat, 1.0)), 0.0, 15.0))
                        if qfp - self.q >= 1.5:
                            self._n_est = n_hat
                            self.qfp = qfp
                        else:
                            self.qfp = float(self.q)
                elif slot_state == SLOT_COLLISION:
                    self.qfp = min(self.qfp + self.q_c, 15.0)
                elif slot_state == SLOT_EMPTY:
                    self.qfp = max(self.qfp - self.q_c, 0.0)
            slots_left -= 1
            if self.adaptive and round(self.qfp) != self.q:
                next_cmd = "query_adjust"
            elif slots_left <= 0:
                # Round boundary: full-round decode evidence drives the
                # link-rate ladder (no-op without link_profiles).
                self._link_update(round_occupied, round_epc_ok)
                if self.target_ab and round_occupied == 0:
                    # A full Query round with zero occupied slots: this
                    # pass's population is exhausted (all inventoried into
                    # the other flag) - flip the target and read it back.
                    self.target ^= 1
                    st.n_target_flips += 1
                    _log.debug("TARGET FLIP -> %s", "AB"[self.target])
                next_cmd = "query"
            else:
                next_cmd = "query_rep"
            st.slot_latency_s.append(time.perf_counter() - t0)
        return st
