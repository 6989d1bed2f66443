"""Phase-based tag ranging (PDOA) and Doppler velocity estimation.

New capability (no reference analogue): the reference computes a per-read
channel estimate ``h_est`` (tag_decoder_impl.cc:103) and throws it away; this
framework surfaces it per read (runtime/stats.py::tag_signal_report), and this
module turns those observables into the two standard commercial-reader
localization primitives:

* **Frequency-domain PDOA ranging**: the backscatter round trip imposes
  ``phi(f) = phi_tag - 4 pi f d / c  (mod 2 pi)`` on the reported phase, so
  the phase *slope across hop frequencies* yields the range
  ``d = -c / (4 pi) * dphi/df`` with per-channel tag/cable offsets cancelled.
  Adjacent FCC hop channels (500 kHz) give an unambiguous range of
  ``c / (2 * 0.5 MHz) / 2 = 150 m`` - far beyond passive-tag link budgets.

* **Doppler velocity**: at a fixed carrier, radial motion rotates the phase
  over time, ``dphi/dt = -4 pi f v / c``, so the per-read phase series inside
  one capture gives the radial velocity ``v = -c / (4 pi f) * dphi/dt``.

Both estimators are plain least-squares fits on unwrapped phase - host-side
NumPy on a handful of reads per tag (the decode itself stays on-TPU).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

C_LIGHT = 299_792_458.0

# FCC part-15 902-928 MHz hop plan: 50 channels, 500 kHz spacing
# (the reference parks on one of these, apps/reader.py:56 freq=910e6).
FCC_HOP_FREQS_HZ: Tuple[float, ...] = tuple(
    902.75e6 + 0.5e6 * k for k in range(50)
)


def backscatter_phase(freq_hz: float, distance_m: float,
                      phi0: float = 0.0) -> float:
    """Round-trip backscatter phase at one carrier: phi0 - 4 pi f d / c,
    wrapped to (-pi, pi].  phi0 absorbs the tag's modulation phase and any
    cable/antenna offsets (constant across hops, so it cancels in PDOA)."""
    phi = phi0 - 4.0 * np.pi * freq_hz * distance_m / C_LIGHT
    return float(np.angle(np.exp(1j * phi)))


def estimate_range(freqs_hz: Sequence[float], phases_rad: Sequence[float],
                   ) -> Dict[str, float]:
    """PDOA range fit across hop frequencies.

    phases are wrapped per-channel measurements (circular-mean backscatter
    phase from ``tag_signal_report``); they are unwrapped along ascending
    frequency (valid while ``4 pi max_adjacent_df d / c < pi``, i.e.
    d < c / (8 * df) = 75 m at 500 kHz steps) and fit with least squares.

    Returns {"range_m", "slope_rad_per_hz", "resid_rad"}; ``resid_rad`` is
    the RMS fit residual - a confidence signal (multipath inflates it).
    """
    f = np.asarray(freqs_hz, dtype=np.float64)
    p = np.asarray(phases_rad, dtype=np.float64)
    assert f.size == p.size and f.size >= 2
    order = np.argsort(f)
    f, p = f[order], p[order]
    pu = np.unwrap(p)
    slope, icept = np.polyfit(f - f.mean(), pu, 1)
    resid = float(np.sqrt(np.mean((pu - (slope * (f - f.mean()) + icept)) ** 2)))
    return {
        "range_m": float(-slope * C_LIGHT / (4.0 * np.pi)),
        "slope_rad_per_hz": float(slope),
        "resid_rad": resid,
    }


def estimate_velocity(times_s: Sequence[float], phases_rad: Sequence[float],
                      freq_hz: float) -> Dict[str, float]:
    """Doppler radial-velocity fit from a per-read phase series at one
    carrier.  Unwrap is valid while the phase advances < pi between
    consecutive reads: |v| < c / (8 f dt) (~5 m/s at 910 MHz / 10 ms reads).
    Positive = receding (range increasing)."""
    t = np.asarray(times_s, dtype=np.float64)
    p = np.asarray(phases_rad, dtype=np.float64)
    assert t.size == p.size and t.size >= 2
    order = np.argsort(t)
    t, p = t[order], p[order]
    pu = np.unwrap(p)
    slope, icept = np.polyfit(t - t.mean(), pu, 1)
    resid = float(np.sqrt(np.mean((pu - (slope * (t - t.mean()) + icept)) ** 2)))
    return {
        "velocity_mps": float(-slope * C_LIGHT / (4.0 * np.pi * freq_hz)),
        "slope_rad_per_s": float(slope),
        "resid_rad": resid,
    }


def tag_phase_series(dec, cfg) -> Dict[int, Dict[str, np.ndarray]]:
    """Per-tag (time, phase, rssi) series from one decoded capture.

    Times are the gate-trigger instants of each CRC-passed EPC read
    (post-decimation sample index / sample rate); phases are the per-read
    channel-estimate angles.  This is the input to ``estimate_velocity``
    (one capture) and, aggregated across hops, to ``estimate_range``.
    """
    valid = np.asarray(dec.valid) & np.asarray(dec.epc_pass)
    idx = np.asarray(dec.index)[valid]
    tid = np.asarray(dec.tag_id)[valid]
    h = np.asarray(dec.h_est)[valid]
    hc = h[:, 0] + 1j * h[:, 1]
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for t in np.unique(tid):
        m = tid == t
        out[int(t)] = {
            "time_s": idx[m] / cfg.sample_rate,
            "phase_rad": np.angle(hc[m]),
            "rssi_dbfs": 10.0 * np.log10(np.maximum(np.abs(hc[m]) ** 2, 1e-30)),
        }
    return out


def circular_mean(phases_rad: np.ndarray) -> float:
    """Circular mean of wrapped phases (the per-channel PDOA observable)."""
    return float(np.angle(np.mean(np.exp(1j * np.asarray(phases_rad)))))


def range_from_captures(
    per_freq: List[Tuple[float, Dict[int, Dict[str, np.ndarray]]]],
) -> Dict[int, Dict[str, float]]:
    """PDOA ranging from a list of (carrier_hz, tag_phase_series(dec, cfg))
    pairs - one decoded capture per hop channel.  Returns
    {tag_id: estimate_range(...)} for every tag seen on >= 2 channels."""
    by_tag: Dict[int, Dict[float, float]] = {}
    for f, series in per_freq:
        for tid, s in series.items():
            by_tag.setdefault(tid, {})[f] = circular_mean(s["phase_rad"])
    out = {}
    for tid, fp in by_tag.items():
        if len(fp) >= 2:
            fs = sorted(fp)
            out[tid] = estimate_range(fs, [fp[f] for f in fs])
    return out


def estimate_aoa(antenna_pos_m: Sequence[float], phases_rad: Sequence[float],
                 freq_hz: float) -> Dict[str, float]:
    """Interferometric angle of arrival from per-antenna backscatter phases.

    With a common TX path and RX antennas on a linear array at positions
    x_c (meters, along the array axis), a far-field tag at bearing theta
    (from broadside) arrives with per-antenna phase
    ``phi_c = const + 2 pi f x_c sin(theta) / c`` (one-way RX leg only -
    the shared TX leg cancels in differences).  Least-squares fit of the
    unwrapped phase against x_c gives sin(theta); antenna spacing must be
    <= lambda/2 (~16.5 cm at 910 MHz) for unambiguous unwrapping.

    Returns {"aoa_deg", "sin_theta", "resid_rad"}.
    """
    x = np.asarray(antenna_pos_m, dtype=np.float64)
    p = np.asarray(phases_rad, dtype=np.float64)
    assert x.size == p.size and x.size >= 2
    order = np.argsort(x)
    x, p = x[order], p[order]
    lam = C_LIGHT / freq_hz
    for i in range(1, x.size):
        assert x[i] - x[i - 1] <= lam / 2 + 1e-9, (
            "antenna spacing exceeds lambda/2 - AoA ambiguous")
    pu = np.unwrap(p)
    slope, icept = np.polyfit(x - x.mean(), pu, 1)
    resid = float(np.sqrt(np.mean((pu - (slope * (x - x.mean()) + icept)) ** 2)))
    s = float(np.clip(slope * lam / (2.0 * np.pi), -1.0, 1.0))
    return {
        "aoa_deg": float(np.degrees(np.arcsin(s))),
        "sin_theta": s,
        "resid_rad": resid,
    }


def aoa_from_mrc(dec, h_chan, antenna_pos_m: Sequence[float],
                 freq_hz: float) -> Dict[int, Dict[str, float]]:
    """Per-tag AoA from a diversity decode (decode_capture_mrc_full).

    For every CRC-passed EPC read, the per-channel phase differences
    relative to antenna 0 are averaged circularly across reads (absolute
    phase varies read-to-read with tag state; the inter-antenna
    differences are geometry), then fit with estimate_aoa.
    """
    valid = np.asarray(dec.valid) & np.asarray(dec.epc_pass)
    tid = np.asarray(dec.tag_id)[valid]
    h = np.asarray(h_chan)[valid]                 # (R, C, 2)
    hc = h[..., 0] + 1j * h[..., 1]               # (R, C)
    out: Dict[int, Dict[str, float]] = {}
    for t in np.unique(tid):
        m = tid == t
        rel = hc[m] * np.conj(hc[m][:, :1])       # phase vs antenna 0
        rel = rel / np.maximum(np.abs(rel), 1e-30)
        phases = np.angle(rel.mean(axis=0))       # circular mean per antenna
        out[int(t)] = estimate_aoa(antenna_pos_m, phases, freq_hz)
    return out
