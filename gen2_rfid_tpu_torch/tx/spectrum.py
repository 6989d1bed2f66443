"""Reader transmit spectrum: occupied channels vs the Gen2 Annex-G masks.

New capability with no reference analogue: the reference transmits
rectangular PIE envelopes (``reader_impl.cc:83-128``) and never examines
its own spectrum, but a deployable interrogator must meet the EPC Gen2
Annex-G transmit masks (and the local regulator's limits) — the *reader*
half of dense-reader mode, complementing the *tag* half (Miller
subcarriers, ``dsp/miller.py``, tests/test_dense_reader.py).

The masks bound the TX power falling into neighboring 500 kHz channels,
relative to the own-channel power (dBch), measured on the baseband
envelope (DSB-ASK: the RF spectrum is the envelope spectrum translated
to the carrier):

==================  ==========  ==========  ==========
mask                |offset|=1  |offset|=2  |offset|>2
==================  ==========  ==========  ==========
``"multi"`` (G.1)    -20 dBch    -50 dBch    -60 dBch
``"dense"`` (G.2)    -30 dBch    -60 dBch    -65 dBch
==================  ==========  ==========  ==========

Rectangular PIE edges are ~µs-scale steps whose sinc tails decay only
~20 dB/decade — they fail both masks at the first adjacent channel.
Gaussian envelope shaping (``cfg.tx_shape_us``, tx/pie.py) concentrates
the command energy in-channel; the measured trade-off (sigma vs mask
margin vs Gen2 table 6.5 envelope limits) is pinned in
tests/test_tx_spectrum.py.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..config import ReaderConfig
from ..protocol import gen2
from .pie import PieEncoder

#: Gen2 v2 Annex G: adjacent-channel power limits (dBch) by |offset|.
MASKS = {
    "multi": {1: -20.0, 2: -50.0, 3: -60.0},
    "dense": {1: -30.0, 2: -60.0, 3: -65.0},
}


def inventory_tx_stream(cfg: ReaderConfig, n_cmds: int = 64,
                        seed: int = 0) -> np.ndarray:
    """A representative TX envelope: Query + per-slot ACKs with random
    RN16s, each followed by its CW listen window — the duty cycle a real
    inventory presents to the spectrum analyzer."""
    enc = PieEncoder(cfg)
    rng = np.random.default_rng(seed)
    parts = []
    pol = 1.0   # PR-ASK carrier polarity carries across segments
    for k in range(n_cmds):
        if k % 2 == 0:
            w, n_cw = enc.query(), cfg.n_cwquery_tx
        else:
            w, n_cw = enc.ack(rng.integers(0, 2, 16)), cfg.n_cwack_tx
        parts.append(w * pol)
        if float(np.real(w[-1])) < 0:
            pol = -pol
        parts.append(np.full(n_cw, pol, w.dtype))
    return np.concatenate(parts)


def _analog_envelope(env: np.ndarray, os: int = 8,
                     dac: str = "foh") -> np.ndarray:
    """DAC reconstruction model at ``os``x the DAC rate.

    The 1 µs DAC grid's Nyquist (500 kHz) is exactly one channel
    spacing — measuring the sampled envelope directly would declare
    every offset >= 2 empty by construction, so the reconstruction
    matters:

    * ``"foh"`` — first-order hold (linear interpolation): a cheap DAC
      with no reconstruction filtering.  Conservative: baseband content
      images around multiples of the DAC rate with only sinc²
      attenuation (this is also what buries SSB's suppressed sideband —
      single-sideband TX *needs* the interpolating model).
    * ``"ideal"`` — bandlimited (FFT zero-pad) interpolation: an
      interpolating DAC + reconstruction filter, e.g. a USRP's TX
      chain.  No images; everything beyond ±500 kHz is whatever the
      digital waveform actually contains.
    """
    env = np.asarray(env)
    cplx = np.iscomplexobj(env)
    if dac == "ideal":
        x = env.astype(np.complex128 if cplx else np.float64)
        spec = np.fft.fft(x)
        n = x.size
        big = np.zeros(n * os, np.complex128)
        h = n // 2
        big[:h] = spec[:h]
        big[-(n - h):] = spec[h:]
        out = np.fft.ifft(big) * os
        return out if cplx else out.real
    assert dac == "foh", dac
    n = env.size
    x = np.arange(n, dtype=np.float64)
    xi = np.arange(n * os, dtype=np.float64) / os
    if cplx:
        return (np.interp(xi, x, env.real.astype(np.float64))
                + 1j * np.interp(xi, x, env.imag.astype(np.float64)))
    return np.interp(xi, x, env.astype(np.float64))


def channel_powers(env: np.ndarray, dac_rate: float,
                   spacing_hz: float = 500e3,
                   n_offsets: int = 3, os: int = 8,
                   dac: str = "foh") -> Dict[int, float]:
    """Per-channel TX power (dBch, relative to the own channel).

    Welch-averaged periodogram of the DAC-reconstructed baseband (real
    envelope for DSB/PR-ASK, complex analytic signal for SSB-ASK),
    integrated over ``spacing_hz``-wide channels centered at
    ±k*spacing_hz.  Offset k reports the WORSE of the two sides — each
    RF channel is one frequency range, so a mask applies per side (for
    real basebands the sides are equal by symmetry; SSB's whole point is
    that they are not).
    """
    env = _analog_envelope(env, os, dac)
    dac_rate = dac_rate * os
    nseg = 8192
    hop = nseg // 2
    win = np.hanning(nseg)
    acc = np.zeros(nseg)
    n = 0
    for s in range(0, env.size - nseg + 1, hop):
        seg = env[s: s + nseg] * win
        acc += np.abs(np.fft.fft(seg)) ** 2
        n += 1
    assert n > 0, "envelope too short for a PSD estimate"
    psd = acc / n
    freqs = np.fft.fftfreq(nseg, d=1.0 / dac_rate)
    own = psd[np.abs(freqs) <= spacing_hz / 2].sum()
    out = {0: 0.0}
    for k in range(1, n_offsets + 1):
        lo, hi = (k - 0.5) * spacing_hz, (k + 0.5) * spacing_hz
        p = max(psd[(freqs > lo) & (freqs <= hi)].sum(),
                psd[(freqs < -lo) & (freqs >= -hi)].sum())
        out[k] = float(10 * np.log10(max(p, 1e-30) / own))
    return out


def mask_check(cfg: ReaderConfig, mask: str = "dense",
               spacing_hz: float = 500e3,
               dac: str = "foh") -> Tuple[bool, Dict[int, float]]:
    """Measure a representative inventory TX against an Annex-G mask.

    Returns (passes, {offset: dBch}) — margin inspection for tests and
    the CLI.  Offsets beyond 3 use the >2 limit.
    """
    limits = MASKS[mask]
    powers = channel_powers(inventory_tx_stream(cfg), cfg.dac_rate,
                            spacing_hz, dac=dac)
    ok = all(powers[k] <= limits[min(k, 3)] for k in powers if k > 0)
    return ok, powers


def envelope_metrics(cfg: ReaderConfig) -> Dict[str, float]:
    """Gen2 table 6.5 RF-envelope figures of a shaped data-0 symbol:
    10-90% rise/fall times (µs) of the PW pulse and modulation depth
    (A-B)/A.  The spec requires depth >= 0.90 and transition times
    < 0.33 Tari — the bound that caps how much Gaussian smoothing the
    link tolerates."""
    enc = PieEncoder(cfg)
    # A lone data-0 between CWs: the PW low pulse is the envelope's
    # deepest, fastest feature.  |·| measures the RF envelope whatever
    # the modulation (PR-ASK's reversal dips reach exactly zero).
    w = np.abs(enc._finish(np.concatenate(
        [np.ones(64, np.float32), enc.data0, np.ones(64, np.float32)])))
    a = float(w.max())
    b = float(w.min())
    lo_i = int(np.argmin(w))
    # falling edge: last crossing of 90% before the minimum; 10% after.
    t10, t90 = b + 0.1 * (a - b), b + 0.9 * (a - b)
    pre, post = w[:lo_i], w[lo_i:]
    fall = (lo_i - np.nonzero(pre >= t90)[0][-1]
            - (lo_i - np.nonzero(pre <= t10)[0][0]
               if np.any(pre <= t10) else 0))
    rise = (np.nonzero(post >= t90)[0][0]
            - np.nonzero(post >= t10)[0][0])
    us = 1e6 / cfg.dac_rate
    return {
        "depth": (a - b) / max(a, 1e-12),
        "rise_us": float(rise * us),
        "fall_us": float(abs(fall) * us),
        "tari_us": 2.0 * cfg.pw_us,
    }


def query_is_parseable(cfg: ReaderConfig) -> bool:
    """Self-check: the shaped Query still demodulates through the PIE
    command sniffer (runtime/sniffer.py) — shaping must never cost
    protocol function."""
    from ..runtime.sniffer import sniff_commands

    enc = PieEncoder(cfg)
    up = int(round(cfg.adc_rate / cfg.dac_rate))
    env = np.concatenate([np.ones(400, np.float32), enc.query(),
                          np.ones(400, np.float32)])
    iq = np.repeat(env, up).astype(np.complex64)
    cmds = [c for c in sniff_commands(iq, cfg)
            if c.get("name") != "power_down"]
    if len(cmds) != 1 or cmds[0].get("name") != "query":
        return False
    want = gen2.query_bits(cfg)
    q = cmds[0]
    return (q.get("crc_ok", False)
            and q.get("q") == gen2.parse_query_q(want)
            and q.get("m") in (None, gen2.parse_query_m(want)))
