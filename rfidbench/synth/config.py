"""Reader configuration: EPC Gen2 protocol constants and derived sample counts.

TPU-native re-design of the reference's two-tier static config
(compile-time constants in ``gr-rfid/include/rfid/global_vars.h:69-143`` plus
Python knobs in ``gr-rfid/apps/reader.py:52-61``).  Everything lives in one
frozen (hashable) dataclass so it can be passed as a jit-static argument; all
derived sample-domain quantities (the reference computes them in the block
constructors, ``gate_impl.cc:48-53``, ``tag_decoder_impl.cc:60``,
``reader_impl.cc:51-71``) are exposed as cached properties with the *same
integer-truncation semantics* so the decode arithmetic matches the reference
bit-for-bit in compat mode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


# Valid 4-bit encodings of Q (global_vars.h:79-85).
Q_VALUE: Tuple[Tuple[int, ...], ...] = tuple(
    tuple((q >> (3 - b)) & 1 for b in range(4)) for q in range(16)
)

# FM0 preamble half-bit pattern, as 0/1 chips (global_vars.h:136); as a
# correlation template the 0 chips act as -1 (tag_decoder_impl.cc:102).
TAG_PREAMBLE_BITS_PATTERN: Tuple[int, ...] = (1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 1, 1)

# Command bit codes (global_vars.h:115-133).
QUERY_CODE: Tuple[int, ...] = (1, 0, 0, 0)
ACK_CODE: Tuple[int, ...] = (0, 1)
QADJ_CODE: Tuple[int, ...] = (1, 0, 0, 1)
NAK_CODE: Tuple[int, ...] = (1, 1, 0, 0, 0, 0, 0, 0)
QREP_CODE: Tuple[int, ...] = (0, 0)
# Q_UPDN rows: increment / unchanged / decrement (global_vars.h:133).
Q_UPDN: Tuple[Tuple[int, ...], ...] = ((1, 1, 0), (0, 0, 0), (0, 1, 1))


@dataclasses.dataclass(frozen=True)
class ReaderConfig:
    """All protocol / radio constants. Frozen + hashable => jit-static."""

    # ---- slotting / termination (global_vars.h:72-76,100) ----
    fixed_q: int = 0
    max_num_queries: int = 1000
    max_unique_tags: int = 100

    # ---- timings in microseconds (global_vars.h:90-97) ----
    cw_us: int = 250          # carrier wave chunk
    p_down_us: int = 2000     # power-down
    t1_us: int = 240          # interrogator->tag turnaround
    t2_us: int = 480          # tag->interrogator turnaround
    pw_us: int = 12           # half Tari
    delim_us: int = 12        # preamble start delimiter
    trcal_us: int = 200       # TRcal: BLF = DR_ratio/TRcal
    rtcal_us: int = 72        # RTcal = 6 * PW

    # ---- gate detection (global_vars.h:99,139-143) ----
    num_pulses_command: int = 5
    thresh_fraction: float = 0.75
    win_size_us: int = 250    # amplitude moving-average window
    dc_size_us: int = 120     # DC-offset estimation window

    # ---- frame sizes in bits (global_vars.h:104-108) ----
    pilot_tone_bits: int = 12
    tag_preamble_bits: int = 6
    rn16_bits: int = 17       # 16 + dummy
    epc_bits: int = 129       # PC16 + EPC96 + CRC16 + dummy
    query_length: int = 22

    # ---- link (global_vars.h:110-121) ----
    blf_hz: float = 40e3      # backscatter link frequency
    miller_m: int = 1         # 1 = FM0; 2/4/8 = Miller subcarrier
    dr: int = 0               # divide ratio bit (0 -> DR=8)
    trext: int = 0
    sel: Tuple[int, int] = (0, 0)
    session: Tuple[int, int] = (0, 0)
    target: int = 0

    # ---- radio / rates (apps/reader.py:52-58) ----
    adc_rate: float = 2e6     # RX complex sample rate (pre-decimation)
    dac_rate: float = 1e6     # TX sample rate
    decim: int = 5            # matched-filter decimation
    ampl: float = 0.1         # TX amplitude
    freq_hz: float = 910e6
    rx_gain: float = 20.0
    tx_gain: float = 0.0

    # ---- framework knobs (new; no reference equivalent) ----
    # Max command events decoded per block (fixed-capacity static shape).
    max_events: int = 1024
    # EPC symbol-period search grid: half-period candidates span
    # [T/2*(1-frac), T/2*(1+frac)] in `steps` steps.  The reference pins
    # +-1% / 20 steps (tag_decoder_impl.cc:151-156) - enough for its trace,
    # but Gen2 tolerates several percent of tag BLF error; widen in native
    # mode to decode off-nominal tags (compat ignores these and pins the
    # reference grid).
    epc_grid_frac: float = 0.01
    epc_grid_steps: int = 20
    # Miller BLF-error hypothesis span (fraction): the preamble-sync
    # template grid and the per-segment joint (offset, period) search in
    # dsp/miller.py cover +-miller_grid_frac of tag clock error, and
    # native-mode Miller decode windows are sized for the slowest tag in
    # the span.  Gen2 table 6.9 allows up to +-4..22% FT depending on
    # link; 4% covers the BLF=160-640 kHz rows at their spec limits.
    miller_grid_frac: float = 0.04
    # TX envelope pulse shaping (tx/pie.py): Gaussian-filter the PIE
    # envelope with this sigma (us).  0 = rectangular edges (the
    # reference's tables, reader_impl.cc:83-128) - those edges occupy
    # several adjacent 500 kHz channels and cannot meet the Gen2 Annex-G
    # dense-interrogator transmit mask; sigma ~2.5 us passes it while
    # keeping the RF envelope inside table 6.5 (rise/fall < 0.33 Tari,
    # modulation depth >= 90%) - see tx/spectrum.py.
    tx_shape_us: float = 0.0
    # Interrogator modulation (Gen2 6.3.1.2 defines DSB-ASK, SSB-ASK,
    # PR-ASK).  "dsb" = DSB-ASK, the reference's real 0/1 envelope
    # (reader_impl.cc:83-128); "pr" = PR-ASK (carrier phase reverses
    # through zero at every PIE low - the modulation commercial readers
    # actually run; requires tx_shape_us > 0, since the reversal
    # transition IS the envelope dip).  SSB-ASK is deliberately NOT
    # offered: exact sideband filtering of full-depth PIE fills the
    # envelope dips past the table 6.5 depth limit (measured in
    # tests/test_tx_mod.py::test_ssb_incompatible_with_full_depth_pie),
    # and the envelope-exact minimum-phase alternative loses the single
    # sideband to sampling aliasing - the same trade that pushed
    # industry to PR-ASK.
    tx_mod: str = "dsb"
    # Use the fused Pallas gate front-end (kernels/gate_front.py) for
    # FIR + amplitude + moving sums instead of separate XLA passes
    # (interpret mode on CPU; validated on TPU hardware round 2).
    pallas_front: bool = False
    # Decision-directed channel tracking across EPC frames (FM0 native
    # mode): re-estimates h per 8-bit segment from confident decisions,
    # extending CFO tolerance ~10x over the reference's frozen preamble
    # h_est (dsp/fm0.py::_track_and_slice).
    track_channel: bool = False
    # CRC-guided soft-decision EPC recovery (runtime/softfix.py): re-slice
    # failed frames by flipping singles/pairs of the K least-reliable
    # detector decisions and accepting the min-cost candidate that passes
    # the full PC-aware CRC validation.  0 disables; 8 is a good default
    # (36 candidates/frame, ~5.5e-4 false-accept per failed frame).
    epc_softfix: int = 0
    # Capture-level CW interferer cancellation (dsp/interference.py):
    # estimate up to this many strong off-DC tones from the whole capture
    # (FFT peak -> half-capture projection-phase frequency refinement ->
    # LS amp/phase) and subtract them before the front end.  Time
    # coherence separates a neighboring reader's carrier from backscatter
    # even when the tone sits exactly ON the Miller subcarrier (where
    # per-frame template integration cannot - the round-5 sweep's M=2
    # cells).  A 15 dB spectral-excess guard makes it a no-op on clean
    # captures, so the golden tuple is unchanged with the flag on.
    # 0 disables (default).
    cancel_cw: int = 0
    # "compat" pins reference truncation/rounding exactly; "native" may use
    # cleaner arithmetic where results provably agree on in-spec signals.
    mode: str = "native"

    # ------------------------------------------------------------------
    # Link-geometry construction (Gen2 6.3.1.2: PIE timing + divide ratio).
    # ------------------------------------------------------------------

    @classmethod
    def for_link(cls, blf_hz: float, tari_us: float = 24.0, dr: int = 0,
                 **kw) -> "ReaderConfig":
        """Config with a *consistent* PIE / link geometry.

        The reference pins every timing at compile time (Tari 24 us via
        PW_D=12, TRcal 200 us, DR=8 -> BLF 40 kHz, global_vars.h:90-116)
        and they happen to agree; this constructor derives them the way
        the spec couples them (Gen2 6.3.1.2): PW = Tari/2, data-0 = Tari,
        data-1 = 2*Tari, RTcal = data-0 + data-1 = 3*Tari, and
        TRcal = DR/BLF (the tag clocks its backscatter off the TRcal it
        measures), validated against the spec envelopes
        (6.25 <= Tari <= 25 us; 1.1*RTcal <= TRcal <= 3*RTcal).
        Defaults reproduce the reference geometry exactly.
        """
        assert dr in (0, 1)
        dr_ratio = 8.0 if dr == 0 else 64.0 / 3.0
        trcal_us = dr_ratio / blf_hz * 1e6
        rtcal_us = 3.0 * tari_us
        assert 6.25 <= tari_us <= 25.0, f"Tari {tari_us} us out of spec"
        assert 1.1 * rtcal_us <= trcal_us <= 3.0 * rtcal_us, (
            f"TRcal {trcal_us:.2f} us outside [1.1, 3]*RTcal "
            f"({rtcal_us} us) - pick a different Tari/DR for BLF "
            f"{blf_hz / 1e3:.0f} kHz")
        pw = tari_us / 2.0
        # Keep exact ints where the geometry lands on them (the reference
        # operating point) so compat-mode truncation arithmetic is
        # unchanged.
        def _i(x):
            return int(x) if float(x).is_integer() else x

        return cls(blf_hz=blf_hz, dr=dr, pw_us=_i(pw),
                   rtcal_us=_i(rtcal_us), trcal_us=_i(trcal_us), **kw)

    @property
    def tari_us(self) -> float:
        """Reference time interval (data-0 length) = 2*PW (Gen2 6.3.1.2.3)."""
        return 2.0 * self.pw_us

    @property
    def dr_ratio(self) -> float:
        """TRcal divide ratio (Gen2 6.3.1.2.8): DR bit 0 -> 8, 1 -> 64/3."""
        return 8.0 if self.dr == 0 else 64.0 / 3.0

    @property
    def blf_from_trcal(self) -> float:
        """Link frequency a tag would derive from the transmitted TRcal:
        BLF = DR/TRcal (Gen2 6.3.1.2.8).  Equals ``blf_hz`` for configs
        built by ``for_link``; the reference's constants also agree
        (8/200 us = 40 kHz)."""
        return self.dr_ratio / (self.trcal_us * 1e-6)

    # ------------------------------------------------------------------
    # Derived sample-domain quantities at the post-decimation rate.
    # ------------------------------------------------------------------

    @property
    def sample_rate(self) -> float:
        """RX rate after matched-filter decimation (apps/reader.py:76)."""
        return self.adc_rate / self.decim

    @property
    def tag_bit_us(self) -> float:
        """Tag bit duration in us (global_vars.h:111)."""
        return 1e6 / self.blf_hz

    @property
    def n_samples_tag_bit(self) -> float:
        """Samples per tag bit; kept float like tag_decoder_impl.cc:60."""
        return self.tag_bit_us * self.sample_rate / 1e6

    @property
    def n_samples_tag_bit_i(self) -> int:
        """Integer-truncated samples/bit as used by the gate (gate_impl.cc:50)."""
        return int(self.n_samples_tag_bit)

    @property
    def n_samples_t1(self) -> int:
        return int(self.t1_us * (self.sample_rate / 1e6))

    @property
    def n_samples_pw(self) -> int:
        # int(4.8) == 4 at the default rates - truncation is load-bearing
        # (gate_impl.cc:49; pulse width test uses n_samples_pw // 2).
        return int(self.pw_us * (self.sample_rate / 1e6))

    @property
    def win_length(self) -> int:
        return int(self.win_size_us * (self.sample_rate / 1e6))

    @property
    def dc_length(self) -> int:
        return int(self.dc_size_us * (self.sample_rate / 1e6))

    @property
    def effective_preamble_bits(self) -> int:
        """Reply preamble length in bit periods for the active encoding:
        FM0: 6 (global_vars.h:105), +12 pilot-tone zero bits when TRext=1
        (PILOT_TONE, global_vars.h:104 - declared but unused by the
        reference, which pins TREXT=0).  Miller: 4 spin-up bits + 010111 at
        TRext=0, 16 spin-up bits at TRext=1 (Gen2 spec figure 6.11)."""
        if self.miller_m == 1:
            return self.tag_preamble_bits + (self.pilot_tone_bits if self.trext else 0)
        return 10 if not self.trext else 22

    @property
    def chips_per_bit(self) -> int:
        """Backscatter chips (half-bits / subcarrier half-cycles) per bit."""
        return 2 * self.miller_m

    @property
    def n_samples_chip(self) -> float:
        """Post-decimation samples per chip (float)."""
        return self.n_samples_tag_bit / self.chips_per_bit

    @property
    def window_slack(self) -> int:
        """Samples of front slack in a decode window (response-start jitter).

        Compat: the reference's 2 truncated tag bits (gate_impl.cc:115,121).
        Native: additionally at least 36 us of jitter coverage, so configs
        with short tag bits (high BLF) still capture replies that start a
        fixed turnaround after the gate opens.  Coincides with the reference
        value (20) at the default 40 kHz / 400 ksps operating point.
        """
        base = 2 * self.n_samples_tag_bit_i
        if self.mode == "compat":
            return base
        return max(base, int(math.ceil(36e-6 * self.sample_rate)))

    @property
    def rn16_window(self) -> int:
        """Gate ungate length for an RN16 response (gate_impl.cc:121).

        Native mode sizes the frame span with ceil of the float bit length
        (the reference truncates, which clips frame tails whenever
        samples-per-bit is not an integer - it only ever ran at 10.0).
        """
        n_bits = self.rn16_bits + self.effective_preamble_bits
        if self.mode == "compat":
            return n_bits * self.n_samples_tag_bit_i + self.window_slack
        return int(math.ceil(n_bits * self.n_samples_tag_bit)) + self.window_slack

    @property
    def epc_window(self) -> int:
        """Gate ungate length for an EPC response (gate_impl.cc:115).

        Native mode sizes the window for the *slowest* tag the period grid
        can estimate (BLF epc_grid_frac below nominal), so off-nominal
        frames are never tail-clipped.
        """
        n_bits = self.epc_bits + self.effective_preamble_bits
        if self.mode == "compat":
            return n_bits * self.n_samples_tag_bit_i + self.window_slack
        span = n_bits * self.n_samples_tag_bit * (1.0 + self._span_frac)
        return int(math.ceil(span)) + self.window_slack

    @property
    def _span_frac(self) -> float:
        """Slowest-decodable-tag fraction for native window sizing: the
        FM0 period grid's half-span, or the Miller joint-search span."""
        if self.miller_m == 1:
            return self.epc_grid_frac
        return self.miller_grid_frac

    @property
    def rn16_half_bits(self) -> int:
        """Half-bits collected for RN16 (tag_decoder_impl.cc:246)."""
        return 2 * (self.rn16_bits - 1)

    def reply_window(self, n_data_bits: int) -> int:
        """Gate ungate length for an arbitrary n-data-bit tag reply (the
        rn16_window formula generalized: access-command replies - Req_RN
        handles, Read data - have other lengths; the reference has only
        the two hard-coded windows, gate_impl.cc:115,121)."""
        n_bits = n_data_bits + 1 + self.effective_preamble_bits
        if self.mode == "compat":
            return n_bits * self.n_samples_tag_bit_i + self.window_slack
        span = n_bits * self.n_samples_tag_bit
        if self.miller_m > 1:
            # Size for the slowest tag the joint (offset, period) segment
            # search can track (dsp/miller.py): long Miller access replies
            # elongate past the slack at percent-level BLF error.
            span *= 1.0 + self.miller_grid_frac
        return int(math.ceil(span)) + self.window_slack

    @property
    def epc_data_bits(self) -> int:
        """Decoded EPC payload bits: PC+EPC+CRC (tag_decoder_impl.cc:317)."""
        return self.epc_bits - 1

    @property
    def sync_search(self) -> int:
        """Preamble-offset search range (tag_decoder_impl.cc:85).

        Native mode searches the full window slack so reply-start jitter is
        covered at every BLF; compat pins the reference's 1.5 tag bits.
        """
        if self.mode == "compat":
            return int(1.5 * self.n_samples_tag_bit)
        base = max(int(1.5 * self.n_samples_tag_bit), self.window_slack)
        if self.trext and self.miller_m == 1:
            # FM0: the 6-bit sync pattern sits after the pilot tone, so the
            # correlation search must skip past it.  (Miller needs no extra
            # search: its sync template includes the spin-up extension.)
            base += int(math.ceil(self.pilot_tone_bits * self.n_samples_tag_bit))
        return base

    @property
    def preamble_half_bits(self) -> int:
        return 2 * self.tag_preamble_bits

    @property
    def max_slot_number(self) -> int:
        return 2 ** self.fixed_q

    # ---- TX-side sample counts at DAC rate (reader_impl.cc:51-71) ----

    @property
    def tx_sample_us(self) -> float:
        return 1e6 / self.dac_rate

    @property
    def n_data0_tx(self) -> int:
        return int(2 * self.pw_us / self.tx_sample_us)

    @property
    def n_data1_tx(self) -> int:
        return int(4 * self.pw_us / self.tx_sample_us)

    @property
    def n_pw_tx(self) -> int:
        return int(self.pw_us / self.tx_sample_us)

    @property
    def n_cw_tx(self) -> int:
        return int(self.cw_us / self.tx_sample_us)

    @property
    def n_delim_tx(self) -> int:
        return int(self.delim_us / self.tx_sample_us)

    @property
    def n_trcal_tx(self) -> int:
        return int(self.trcal_us / self.tx_sample_us)

    @property
    def rn16_us(self) -> int:
        return int((self.rn16_bits + self.effective_preamble_bits) * self.tag_bit_us)

    @property
    def epc_us(self) -> int:
        return int((self.epc_bits + self.effective_preamble_bits) * self.tag_bit_us)

    @property
    def n_cwquery_tx(self) -> int:
        """CW after Query/QueryRep: covers T1+T2+RN16 (reader_impl.cc:69)."""
        return int((self.t1_us + self.t2_us + self.rn16_us) / self.tx_sample_us)

    @property
    def n_cwack_tx(self) -> int:
        """CW after ACK: covers 3*T1+T2+EPC (reader_impl.cc:70)."""
        return int((3 * self.t1_us + self.t2_us + self.epc_us) / self.tx_sample_us)

    @property
    def n_p_down_tx(self) -> int:
        return int(self.p_down_us / self.tx_sample_us)


DEFAULT_CONFIG = ReaderConfig()
