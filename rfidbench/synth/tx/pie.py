"""PIE (pulse-interval encoding) baseband waveform synthesis at DAC rate.

TPU-native equivalent of the reader block's precomputed TX tables
(``reader_impl.cc:51-128``): data-0/data-1 symbols, delimiter, RTcal, TRcal,
preamble, frame-sync, CW segments and full command waveforms.  Synthesis is
table-driven NumPy (host side): command waveforms are short, static per
config, and are either written to a trace (simulation) or staged to the device
once as jit-constants for the closed-loop schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..config import ReaderConfig
from ..protocol import gen2


@dataclasses.dataclass
class PieEncoder:
    """Precomputed PIE segment tables for one config (reader_impl.cc:83-128)."""

    cfg: ReaderConfig

    def __post_init__(self):
        c = self.cfg
        f32 = np.float32

        def seg(n_total: int, n_high: int) -> np.ndarray:
            w = np.zeros(n_total, dtype=f32)
            w[:n_high] = 1.0
            return w

        # data-0: 2*PW, first half high; data-1: 4*PW, first 3/4 high
        # (reader_impl.cc:92-93).
        self.data0 = seg(c.n_data0_tx, c.n_data0_tx // 2)
        self.data1 = seg(c.n_data1_tx, 3 * c.n_data1_tx // 4)
        # delimiter: all low (reader_impl.cc:87 leaves delim zero-initialized).
        self.delim = np.zeros(c.n_delim_tx, dtype=f32)
        # RTcal = data0+data1 long, last PW low; TRcal likewise
        # (reader_impl.cc:88-96).
        n_rtcal = c.n_data0_tx + c.n_data1_tx
        self.rtcal = seg(n_rtcal, n_rtcal - c.n_pw_tx)
        self.trcal = seg(c.n_trcal_tx, c.n_trcal_tx - c.n_pw_tx)
        self.cw = np.ones(c.n_cw_tx, dtype=f32)
        self.cw_query = np.ones(c.n_cwquery_tx, dtype=f32)
        self.cw_ack = np.ones(c.n_cwack_tx, dtype=f32)
        self.p_down = np.zeros(c.n_p_down_tx, dtype=f32)
        # Preamble (delim+data0+RTcal+TRcal) and frame-sync (no TRcal)
        # (reader_impl.cc:98-107).
        self.preamble = np.concatenate([self.delim, self.data0, self.rtcal, self.trcal])
        self.frame_sync = np.concatenate([self.delim, self.data0, self.rtcal])
        # Gaussian envelope-shaping kernel (cfg.tx_shape_us > 0): the
        # regulatory face of the TX (tx/spectrum.py) - rectangular PIE
        # edges splatter across adjacent 500 kHz channels; a ~2.5 us
        # Gaussian meets the Gen2 Annex-G dense-interrogator mask while
        # staying inside the table 6.5 RF envelope (rise < 0.33 Tari,
        # depth >= 90%).  Applied to whole command waveforms (not the
        # segment tables) so inter-symbol joins shape correctly.
        self._kern = None
        if c.tx_shape_us > 0:
            sig = c.tx_shape_us * c.dac_rate / 1e6   # sigma in DAC samples
            half = int(np.ceil(4 * sig))
            t = np.arange(-half, half + 1, dtype=np.float64)
            k = np.exp(-0.5 * (t / sig) ** 2)
            self._kern = (k / k.sum()).astype(f32)

    def _shape(self, w: np.ndarray) -> np.ndarray:
        """Shape one command waveform.  Commands sit between CW segments,
        so the boundary context is carrier-on (1.0) on both sides."""
        if self._kern is None:
            return w
        half = self._kern.size // 2
        padded = np.concatenate([np.ones(half, w.dtype), w,
                                 np.ones(half, w.dtype)])
        return np.convolve(padded, self._kern, mode="valid").astype(w.dtype)

    # ---- interrogator modulations (Gen2 6.3.1.2) ----

    def _pr_sign(self, w: np.ndarray) -> np.ndarray:
        """PR-ASK polarity track: the carrier phase reverses at the
        center of every PIE low (Gen2 figure 6.6), so the ±1 square wave
        flips once per low run of the rectangular envelope."""
        low = w < 0.5
        d = np.diff(low.astype(np.int8))
        starts = np.nonzero(d == 1)[0] + 1
        ends = np.nonzero(d == -1)[0] + 1
        if low[0]:
            starts = np.concatenate([[0], starts])
        if low[-1]:
            ends = np.concatenate([ends, [w.size]])
        sgn = np.ones(w.size, np.float32)
        for s, e in zip(starts, ends):
            sgn[(s + e) // 2:] *= -1.0
        return sgn

    def _smooth_sign(self, sgn: np.ndarray) -> np.ndarray:
        """Gaussian-smoothed polarity: the transition through zero IS
        PR-ASK's envelope dip, so shaping is mandatory for tx_mod='pr'."""
        assert self._kern is not None, (
            "PR-ASK needs tx_shape_us > 0: the phase-reversal transition "
            "is the envelope dip the tag demodulates")
        half = self._kern.size // 2
        padded = np.concatenate([np.full(half, sgn[0], np.float32), sgn,
                                 np.full(half, sgn[-1], np.float32)])
        return np.convolve(padded, self._kern, mode="valid").astype(
            np.float32)

    def _finish(self, w: np.ndarray) -> np.ndarray:
        """Rectangular command envelope -> transmitted baseband for the
        configured interrogator modulation.

        SSB-ASK is deliberately absent (see config.tx_mod): exact
        sideband filtering of full-depth PIE fills the envelope dips
        (Hilbert overshoot; measured |s| max 1.56 and decode dead at
        every shaping sigma — tests/test_tx_mod.py pins it via
        :func:`ssb_filtered`), and the envelope-exact minimum-phase
        construction ``env·exp(j·H(ln env))`` loses its single sideband
        to sampling aliasing at realizable DAC rates — the trade that
        made industry standardize on PR-ASK."""
        mode = self.cfg.tx_mod
        if mode == "dsb":
            return self._shape(w)
        assert mode == "pr", f"unknown tx_mod {mode!r}"
        return (self._shape(w) * self._smooth_sign(
            self._pr_sign(w))).astype(np.float32)

    # ---- generic bit encoding ----

    def encode_bits(self, bits: np.ndarray) -> np.ndarray:
        """Concatenate data0/data1 symbols for a bit vector."""
        parts = [self.data1 if b else self.data0 for b in np.asarray(bits).astype(int)]
        if not parts:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(parts)

    # ---- full command waveforms (payloads the reader FSM emits) ----

    def query(self, q: int = None, target: int = None,
              sel=None) -> np.ndarray:
        """Preamble + 22 Query bits (reader_impl.cc:251-281, without the CW).

        ``q``/``target``/``sel`` override the config's fixed Q / target
        flag / Sel field (adaptive live reader / session-inventory passes /
        Select-gated inventory)."""
        return self._finish(np.concatenate(
            [self.preamble,
             self.encode_bits(gen2.query_bits(self.cfg, q, target, sel))]))

    def query_rep(self) -> np.ndarray:
        """Frame-sync + 4 data-0 (reader_impl.cc:109-114)."""
        return self._finish(np.concatenate(
            [self.frame_sync, self.encode_bits(gen2.query_rep_bits(self.cfg))]
        ))

    def ack(self, rn16: np.ndarray) -> np.ndarray:
        """Frame-sync + 18 ACK bits (reader_impl.cc:290-316)."""
        return self._finish(np.concatenate(
            [self.frame_sync, self.encode_bits(gen2.ack_bits(rn16))]))

    def query_adjust(self, updn: int = 0) -> np.ndarray:
        return self._finish(np.concatenate(
            [self.frame_sync, self.encode_bits(gen2.query_adjust_bits(self.cfg, updn))]
        ))

    def nak(self) -> np.ndarray:
        """Frame-sync + NAK code (reader_impl.cc:116-125)."""
        return self._finish(np.concatenate(
            [self.frame_sync, self.encode_bits(gen2.nak_bits())]))

    def select(self, bits: np.ndarray) -> np.ndarray:
        """Frame-sync + Select command bits (Gen2 6.3.2.12.1.1: Select is
        preceded by a frame-sync, not the full preamble - no ref analogue)."""
        return self._finish(np.concatenate(
            [self.frame_sync, self.encode_bits(bits)]))

    def command(self, bits: np.ndarray) -> np.ndarray:
        """Frame-sync + arbitrary command bits (access commands: Req_RN,
        Read - all non-Query commands use the frame-sync, Gen2 6.3.1.2)."""
        return self._finish(np.concatenate(
            [self.frame_sync, self.encode_bits(bits)]))

    def ssb_filtered(self, w: np.ndarray) -> np.ndarray:
        """Plain filtered SSB-ASK (analytic signal) of a shaped command
        envelope — exact single sideband, distorted envelope.  Kept as a
        measurement surface for the documented reason tx_mod has no
        "ssb": tests/test_tx_mod.py pins both sides of the trade
        (sideband suppression vs table 6.5 depth violation)."""
        from scipy.signal import hilbert

        pad = 2048
        x = np.concatenate([np.ones(pad, np.float64),
                            self._shape(w).astype(np.float64),
                            np.ones(pad, np.float64)])
        return hilbert(x)[pad:-pad].astype(np.complex64)

    def tables(self) -> Dict[str, np.ndarray]:
        """All named segments, e.g. for staging to device memory."""
        return {
            "data0": self.data0,
            "data1": self.data1,
            "delim": self.delim,
            "rtcal": self.rtcal,
            "trcal": self.trcal,
            "cw": self.cw,
            "cw_query": self.cw_query,
            "cw_ack": self.cw_ack,
            "p_down": self.p_down,
            "preamble": self.preamble,
            "frame_sync": self.frame_sync,
        }
