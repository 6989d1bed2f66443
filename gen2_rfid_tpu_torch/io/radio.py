"""UHD-style radio adapter: the live reader's air interface on real hardware.

The reference's primary mode drives a USRP N200/N210 through gr-uhd
(``apps/reader.py:17-43``: usrp_source at 2 Msps RX / usrp_sink at 1 Msps
TX, 910 MHz, RX2/TX-RX antennas).  This module provides the same capability
behind the framework's ``exchange()`` channel abstraction, so
``runtime.live.LiveReader`` runs unmodified against real hardware:

* ``RadioChannel`` - turns each exchange into one timed TX burst
  (command envelope * amplitude + CW hold) and one RX capture of matching
  length, through a minimal 2-method driver interface;
* ``UhdDriver`` - import-guarded binding to the ``uhd`` Python API
  (not installed in this environment; constructing it without the package
  raises with instructions);
* ``PieAirDriver`` - a waveform-level mock used by the tests: it
  PIE-*decodes the reader's actual TX envelope* (pulse-interval decode of
  delimiter/RTcal/TRcal framing) to recover which command was sent and
  feeds `sim.channel.SimTagChannel` physics with it.  Nothing is passed
  out-of-band, so a LiveReader inventory through this driver proves the
  transmitted waveforms alone carry the closed loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import ReaderConfig


class RadioChannel:
    """``exchange()`` over a TX/RX sample-stream driver pair.

    ``driver`` must provide two methods (the shape of a UHD streamer pair):

    * ``send(samples: np.complex64 @ dac_rate) -> None`` - transmit one
      burst (command + CW hold), back-to-back with the previous one (the
      reader must hold CW between commands to keep tags powered);
    * ``recv(n_samples: int) -> np.complex64 @ adc_rate`` - the received
      capture aligned to the burst just sent (full-duplex: the reader
      listens while transmitting; the TX leak *is* the gate's sync source).
    """

    def __init__(self, cfg: ReaderConfig, driver, *, ampl: float = 0.1):
        # ampl mirrors the reference's TX scaling (apps/reader.py:59,79).
        self.cfg = cfg
        self.driver = driver
        self.ampl = np.float32(ampl)
        self.up = int(round(cfg.adc_rate / cfg.dac_rate))
        # Carrier polarity carried across exchanges: a PR-ASK command with
        # an odd reversal count ends at -1, and the following CW must
        # continue at that phase or the junction step reads as a spurious
        # PIE pulse (same bookkeeping as sim.channel.SimTagChannel._pol).
        self._pol = np.float32(1.0)

    def exchange(self, kind: str, bits: np.ndarray, tx_env: np.ndarray,
                 cw_us: float) -> np.ndarray:
        cfg = self.cfg
        n_cw = int(round(cw_us * cfg.dac_rate / 1e6))
        env = np.asarray(tx_env, np.float32)
        if kind == "listen":
            # Clear-channel sensing window: the reader's own TX is OFF so
            # the RX measures ambient power, not our TX leak (EN 302 208
            # CCA; transmitting here would defeat the assessment).
            burst = np.zeros(env.size + n_cw, np.float32)
        else:
            cmd = env * self._pol
            if env.size and float(env[-1]) < 0:
                self._pol = -self._pol
            burst = (np.concatenate([cmd, np.full(n_cw, self._pol,
                                                  np.float32)]) * self.ampl)
        self.driver.send(burst.astype(np.complex64))
        return np.asarray(
            self.driver.recv(burst.size * self.up), np.complex64)

    def retune(self, freq_hz: float) -> None:
        """Move TX+RX to a new carrier (FCC hopping / LBT channel moves).

        Loud failure by design: a driver without a ``tune`` method cannot
        do LBT or hopping, and silently staying on one frequency while the
        reader believes it moved violates the regulatory plan."""
        tune = getattr(self.driver, "tune", None)
        if tune is None:
            raise RuntimeError(
                f"{type(self.driver).__name__} has no tune(); LBT/hopping "
                "need a tunable driver")
        tune(float(freq_hz))


class UhdDriver:
    """Real-hardware driver over the ``uhd`` Python API (import-guarded).

    Mirrors the reference's radio setup: TX at ``cfg.dac_rate`` on TX/RX,
    RX at ``cfg.adc_rate`` on RX2, one center frequency
    (apps/reader.py:17-43; defaults freq=910e6, rx_gain=20, tx_gain=25 from
    apps/reader.py:55-58).
    """

    def __init__(
        self,
        cfg: ReaderConfig,
        *,
        freq: float = 910e6,
        rx_gain: float = 20.0,
        tx_gain: float = 25.0,
        addr: str = "",
    ):
        try:
            import uhd  # type: ignore
        except ImportError as e:  # pragma: no cover - no radio in CI
            raise RuntimeError(
                "UhdDriver needs the 'uhd' Python package (pip install uhd "
                "with a USRP attached); for simulation use "
                "sim.channel.SimTagChannel or io.radio.PieAirDriver"
            ) from e
        self._usrp = uhd.usrp.MultiUSRP(addr)  # pragma: no cover
        u = self._usrp
        u.set_tx_rate(cfg.dac_rate)
        u.set_rx_rate(cfg.adc_rate)
        u.set_tx_freq(uhd.types.TuneRequest(freq))
        u.set_rx_freq(uhd.types.TuneRequest(freq))
        u.set_tx_gain(tx_gain)
        u.set_rx_gain(rx_gain)
        u.set_tx_antenna("TX/RX")
        u.set_rx_antenna("RX2")
        st_args = uhd.usrp.StreamArgs("fc32", "sc16")
        self._tx = u.get_tx_stream(st_args)
        self._rx = u.get_rx_stream(st_args)
        md = uhd.types.StreamCMD(uhd.types.StreamMode.start_cont)
        md.stream_now = True
        self._rx.issue_stream_cmd(md)
        self._tx_md = uhd.types.TXMetadata()

    def send(self, samples: np.ndarray) -> None:  # pragma: no cover
        self._tx.send(samples.reshape(1, -1), self._tx_md)

    def tune(self, freq_hz: float) -> None:  # pragma: no cover
        import uhd  # type: ignore

        self._usrp.set_tx_freq(uhd.types.TuneRequest(freq_hz))
        self._usrp.set_rx_freq(uhd.types.TuneRequest(freq_hz))

    def recv(self, n_samples: int) -> np.ndarray:  # pragma: no cover
        import uhd  # type: ignore

        out = np.empty((1, n_samples), np.complex64)
        md = uhd.types.RXMetadata()
        got = 0
        while got < n_samples:
            got += self._rx.recv(out[:, got:], md)
        return out[0]


# ---------------------------------------------------------------------------
# Waveform-level mock driver
# ---------------------------------------------------------------------------


def pie_decode_envelope(env: np.ndarray, cfg: ReaderConfig):
    """Recover (kind, bits) from a DAC-rate PIE envelope.

    Inverse of tx.pie.PieEncoder: every PIE symbol ends with a PW-long low,
    so pulse-start intervals encode the symbols - data-0 spans 2*PW,
    data-1 4*PW (reader_impl.cc:92-93).  The preamble is recognized by its
    delimiter low + data-0 + RTcal(6*PW) framing, with TRcal present only
    on Query (reader_impl.cc:98-107).  All-high is CW, all-low power-down.
    """
    on = np.asarray(env) > 0.5 * np.max(np.abs(env)) if env.size else env
    if env.size == 0 or not on.any():
        # TX-off bursts are on-air ambiguous: a tag rides through a short
        # gap on stored charge (an LBT sensing window, ~200 us) but loses
        # state in a long one (the reference's power-down is 2 ms,
        # reader_impl.cc:71-73).  1 ms splits the two regimes.
        kind = "power_down" if env.size >= cfg.dac_rate * 1e-3 else "listen"
        return (kind, np.zeros(0, np.int64))
    if on.all():
        return ("cw", np.zeros(0, np.int64))
    rises = np.flatnonzero(~on[:-1] & on[1:]) + 1
    if on[0]:
        rises = np.concatenate([[0], rises])
    iv = np.diff(rises)
    d0, d1 = cfg.n_data0_tx, cfg.n_data1_tx

    def near(x, ref):
        return abs(int(x) - ref) <= 2

    # Preamble: [data0, RTcal, (TRcal)] intervals after the delimiter low.
    k = 0
    assert near(iv[k], d0), ("no preamble data-0", iv[:4])
    k += 1
    assert near(iv[k], d0 + d1), ("no RTcal", iv[:4])
    k += 1
    has_trcal = k < iv.size and near(iv[k], cfg.n_trcal_tx)
    if has_trcal:
        k += 1
    bits = []
    for x in iv[k:]:
        if near(x, d0):
            bits.append(0)
        elif near(x, d1):
            bits.append(1)
        else:
            raise AssertionError(f"bad PIE interval {x}")
    # Final symbol's rise-to-CW interval already consumed above; the last
    # rise is the CW start, so `bits` is exactly the payload.
    bits = np.array(bits, dtype=np.int64)
    if has_trcal:
        return "query", bits
    from ..protocol import gen2

    head8 = tuple(bits[:8]) if bits.size >= 8 else None
    if bits.size == 4:
        kind = "query_rep"
    elif bits.size == 18 and tuple(bits[:2]) == tuple(gen2.ACK_CODE):
        kind = "ack"
    elif bits.size == 9 and tuple(bits[:4]) == tuple(gen2.QADJ_CODE):
        kind = "query_adjust"
    elif head8 == tuple(gen2.NAK_CODE):
        kind = "nak"
    elif head8 == gen2.REQ_RN_CODE:
        kind = "req_rn"
    elif head8 == gen2.READ_CODE:
        kind = "read"
    elif head8 == gen2.WRITE_CODE:
        kind = "write"
    elif bits.size >= 4 and tuple(bits[:4]) == gen2.SELECT_CODE:
        kind = "select"
    else:
        raise AssertionError(f"unrecognized command ({bits.size} bits)")
    return kind, bits


@dataclasses.dataclass
class PieAirDriver:
    """Mock TX/RX driver that closes the loop at the waveform level.

    ``send`` PIE-decodes the burst's envelope to recover the command the
    reader actually transmitted; ``recv`` returns the RX capture produced
    by `SimTagChannel` physics for that command.  The channel's tag logic
    (slot counters, RN16-echo enforcement, Q parsed from the Query bits)
    therefore reacts purely to what was on the air.
    """

    channel: "object"           # SimTagChannel (any exchange() provider)
    cfg: ReaderConfig
    ampl: float = 0.1

    def __post_init__(self):
        self._pending: Optional[np.ndarray] = None

    def send(self, samples: np.ndarray) -> None:
        assert self._pending is None, "recv() not drained before next send()"
        env = np.abs(np.asarray(samples, np.complex64)) / self.ampl
        kind, bits = pie_decode_envelope(env, self.cfg)
        # Split command envelope from CW hold: the channel synthesizes its
        # own CW of cw_us, so recover cw_us from the tail length.
        if kind == "listen":
            # TX-off sensing window: no command samples, the whole burst
            # is the listen duration.
            n_cmd = 0
            cw_us = env.size * 1e6 / self.cfg.dac_rate
        elif kind in ("cw", "power_down"):
            n_cmd = env.size
            cw_us = 0.0
        else:
            last_low = int(np.flatnonzero(env < 0.5)[-1])
            n_cmd = last_low + 1
            cw_us = (env.size - n_cmd) * 1e6 / self.cfg.dac_rate
        self._pending = self.channel.exchange(
            kind, bits, env[:n_cmd].astype(np.float32), cw_us)

    def recv(self, n_samples: int) -> np.ndarray:
        rx, self._pending = self._pending, None
        assert rx is not None, "recv() before send()"
        assert rx.size == n_samples, (rx.size, n_samples)
        return rx

    def tune(self, freq_hz: float) -> None:
        """Carrier move (LBT / FCC hopping): forwarded to the channel
        physics the same way UhdDriver.tune forwards to the USRP."""
        self.channel.retune(freq_hz)
