"""RF management for the live reader: link-rate adaptation, listen-
before-talk clear-channel assessment, and the link-profile ladder.

Split out of runtime/live.py (round 4 decomposition); import surface
unchanged (``from gen2_rfid_tpu.runtime.live import ETSI_LOWER_MHZ,
default_link_profiles``).  Frequency hopping itself is two lines in the
main loop; its LBT/channel-plan machinery lives here.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..config import ReaderConfig
from ..tx.pie import PieEncoder

_log = logging.getLogger("gen2_rfid_tpu.live")


#: ETSI EN 302 208 lower-band 4-channel plan (MHz): the four 200 kHz
#: high-power channels European readers share - the natural LBT set.
ETSI_LOWER_MHZ = (865.7, 866.3, 866.9, 867.5)


def default_link_profiles(cfg: ReaderConfig, ms=(1, 2, 4)):
    """A ready-made link ladder from a base config: one profile per
    requested encoding (fastest first), sharing the base radio rates,
    each with the decimation that leaves ~5 RX samples per chip (half-bit
    for FM0) — the reference's own operating density (SURVEY §2.4).

    With the 2 Msps reference rates this yields FM0/decim-5, Miller-2/
    decim-2 and Miller-4/decim-1 (6.25 samples per chip post-decimation
    for the Miller rungs).
    """
    out = []
    for m in ms:
        chip_us = cfg.tag_bit_us / (2 * max(m, 1))
        chip_samples = chip_us * cfg.adc_rate / 1e6
        decim = max(1, int(chip_samples / 5))
        assert chip_samples / decim >= 2.5, (
            f"M={m} chips unresolvable at {cfg.adc_rate/1e6:.1f} Msps")
        out.append(dataclasses.replace(cfg, miller_m=m, decim=decim))
    return out


class RfManagementMixin:
    """Round-boundary RF control: the link-rate ladder walk and the
    EN 302 208-style LBT channel-plan scan."""

    def _apply_link_profile(self, idx: int) -> None:
        """Switch to ladder rung ``idx``: the next Query carries the new
        M/TRext (tags follow it per spec), and the reader's own TX tables,
        decode jits and gate context re-key to the new config."""
        p = self.link_profiles[idx]
        self._link_idx = idx
        self.cfg = p
        self.enc = PieEncoder(p)
        n_taps = int(p.tag_bit_us / 2 * p.adc_rate / 1e6 / p.miller_m)
        self._ctx_len = ((p.win_length + p.n_samples_t1 + 64) * p.decim
                         + n_taps)
        self._reset_ctx()
        self.stats.link_trace.append((self.stats.cur_round, p.miller_m))
        _log.debug("LINK | -> M=%d decim=%d", p.miller_m, p.decim)

    def _link_update(self, occupied: int, ok: int) -> None:
        """Round-boundary rate control: downshift on failing (or, with
        ``link_probe``, silent) rounds, upshift after sustained clean
        rounds.

        ``link_probe`` matters under strong in-channel interference: the
        jammer inflates the gate's CW noise estimate, so jammed slots
        classify *empty* — indistinguishable from an absent tag at this
        layer.  Probing downward on silence is safe either way: an absent
        tag merely parks the reader on the robust rung (reads resume
        immediately when it appears), while a jammed FM0 link walks to
        the Miller rung that clears the interferer — the dense-reader
        autoset behavior."""
        if not self.link_profiles:
            return
        eff = max(occupied, ok)
        if eff == 0:
            if not self.link_probe:
                return
            self._link_bad += 1
            self._link_clean = 0
        elif ok < 0.5 * eff:
            self._link_bad += 1
            self._link_clean = 0
        elif ok == eff:
            self._link_clean += 1
            self._link_bad = 0
        else:
            self._link_bad = 0
            self._link_clean = 0
        if (self._link_bad >= self.link_down_after
                and self._link_idx + 1 < len(self.link_profiles)):
            self._link_bad = 0
            self._link_clean = 0
            self._apply_link_profile(self._link_idx + 1)
        elif self._link_clean >= self.link_up_after and self._link_idx > 0:
            self._link_bad = 0
            self._link_clean = 0
            self._apply_link_profile(self._link_idx - 1)

    # ---- listen-before-talk ----

    def _listen_power(self, channel, bw_hz: float = 200e3) -> float:
        """One TX-off sensing window: mean ambient power INSIDE the
        200 kHz channel (FFT band power) — a neighbor's carrier two
        channels over must not read as local occupancy."""
        rx = np.asarray(channel.exchange(
            "listen", np.zeros(0, np.int64), np.zeros(0, np.float32),
            self.lbt_listen_us))
        if rx.size == 0:
            return 0.0
        spec = np.abs(np.fft.fft(rx)) ** 2
        f = np.fft.fftfreq(rx.size, 1.0 / self.cfg.adc_rate)
        band = np.abs(f) <= bw_hz / 2
        return float(spec[band].sum() / rx.size ** 2)

    def _lbt_note(self, f_mhz: float, power: float) -> None:
        """Record a sensing measurement into the per-channel history (the
        rolling floor estimate; bounded so a permanent ambient rise ages
        old lows out instead of pinning the floor forever)."""
        hist = self._lbt_hist.setdefault(f_mhz, [])
        hist.append(power)
        del hist[:-8]

    def _lbt_thresh(self) -> float:
        """Busy threshold: margin over the freshest floor estimate (min of
        recent sensing windows across the plan), never below the absolute
        minimum (`lbt_floor_min`)."""
        floor = min(min(h) for h in self._lbt_hist.values())
        return max(floor, self.lbt_floor_min) * 10.0 ** (
            self.lbt_margin_db / 10.0)

    def _lbt_check(self, channel) -> None:
        """Clear-channel assessment before a Query round: move off busy
        channels.  The first call surveys the whole plan for its noise
        floor; afterwards every sensing window feeds the rolling
        per-channel floor history so the threshold tracks ambient/gain
        changes instead of going stale."""
        if not self.lbt_mhz:
            return
        if not self._lbt_hist:
            for f in self.lbt_mhz:
                if hasattr(channel, "retune"):
                    channel.retune(f * 1e6)
                self._lbt_note(f, self._listen_power(channel))
            f0 = self.lbt_mhz[self._lbt_idx]
            self._carrier_hz = f0 * 1e6
            if hasattr(channel, "retune"):
                channel.retune(self._carrier_hz)
        for _ in range(len(self.lbt_mhz)):
            p = self._listen_power(channel)
            self._lbt_note(self.lbt_mhz[self._lbt_idx], p)
            if p <= self._lbt_thresh():
                return
            # Busy: defer to the next channel of the plan.
            self.stats.n_lbt_defers += 1
            self._lbt_idx = (self._lbt_idx + 1) % len(self.lbt_mhz)
            f = self.lbt_mhz[self._lbt_idx]
            self._carrier_hz = f * 1e6
            if hasattr(channel, "retune"):
                channel.retune(self._carrier_hz)
            self.stats.lbt_trace.append((self.stats.cur_round, f))
            _log.debug("LBT | busy, -> %.1f MHz", f)
        _log.debug("LBT | all channels busy; transmitting anyway")
