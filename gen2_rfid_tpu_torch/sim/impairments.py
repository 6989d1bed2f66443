"""Receiver-side RF impairments: IQ imbalance, ADC quantization, LO phase
noise, adjacent-reader interference.

The reference was validated against real USRP captures (README.md:43-53),
so its decode chain implicitly survived a real front end; this module
synthesizes those front-end effects so the framework's robustness is
*measured* instead of assumed.  All impairments apply to a complete RX
capture (command leak + backscatter + noise), i.e. after `sim.trace` /
`sim.channel` synthesis and before the decode chain - exactly where the
ADC sits.

Models:

* **IQ imbalance** (direct-conversion front end): gain mismatch ``g`` (dB)
  and quadrature phase error ``phi`` (deg) between the I and Q rails -
  ``I' = I``, ``Q' = g*(Q*cos(phi) + I*sin(phi))``.  Creates an image at
  -f with image-rejection ratio ``IRR = |alpha/beta|^2`` where
  ``alpha = (1 + g*e^{j*phi})/2``, ``beta = (1 - g*e^{j*phi})/2``.
* **ADC quantization**: mid-tread uniform quantizer with ``quant_bits``
  bits per rail over ``[-full_scale, +full_scale]``, with clipping.  The
  carrier leak (~1.0) dominates the dynamic range while the backscatter
  rides ~20-30 dB below it - exactly the regime where low bit depths bite.
* **LO phase noise**: Wiener (random-walk) phase with per-sample standard
  deviation ``phase_walk_rad`` applied to the whole capture.  In a
  monostatic reader the backscatter is self-coherent for the *CFO* part,
  but the round-trip delay de-correlates fast phase noise; the random walk
  is the standard worst-case model.
* **Adjacent-reader interference**: a CW tone at ``interferer_hz`` offset,
  ``interferer_dbc`` below the own-reader leak - the dense-reader
  environment (multiple Gen2 readers sharing the 902-928 MHz band).  The
  matched filter's boxcar response and the gate's windowed statistics must
  both absorb the beat.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RxImpairments:
    """Front-end impairment levels (all off by default)."""

    iq_gain_db: float = 0.0        # I/Q gain mismatch in dB
    iq_phase_deg: float = 0.0      # quadrature phase error in degrees
    quant_bits: int = 0            # ADC bits per rail (0 = ideal)
    full_scale: float = 1.5        # ADC full scale (leak amplitude ~1.0)
    phase_walk_rad: float = 0.0    # per-sample random-walk std (rad)
    interferer_dbc: Optional[float] = None   # CW tone level vs leak (dB)
    interferer_hz: float = 250e3   # CW tone frequency offset

    @property
    def image_rejection_db(self) -> float:
        """IRR implied by the IQ imbalance settings (inf when ideal)."""
        g = 10.0 ** (self.iq_gain_db / 20.0)
        e = g * np.exp(1j * np.deg2rad(self.iq_phase_deg))
        alpha, beta = (1 + e) / 2, (1 - e) / 2
        if abs(beta) == 0:
            return float("inf")
        return float(20.0 * np.log10(abs(alpha) / abs(beta)))


def apply_rx_impairments(
    iq: np.ndarray,
    imp: RxImpairments,
    adc_rate: float,
    seed: int = 0,
) -> np.ndarray:
    """Pass a complex64 capture through the impaired front end."""
    x = np.asarray(iq, dtype=np.complex128)
    rng = np.random.default_rng(seed)

    if imp.interferer_dbc is not None:
        amp = 10.0 ** (imp.interferer_dbc / 20.0)
        n = np.arange(x.size)
        phase0 = rng.uniform(0, 2 * np.pi)
        x = x + amp * np.exp(
            1j * (2 * np.pi * imp.interferer_hz * n / adc_rate + phase0))

    if imp.phase_walk_rad > 0:
        walk = np.cumsum(rng.normal(0.0, imp.phase_walk_rad, x.size))
        x = x * np.exp(1j * walk)

    if imp.iq_gain_db != 0.0 or imp.iq_phase_deg != 0.0:
        g = 10.0 ** (imp.iq_gain_db / 20.0)
        phi = np.deg2rad(imp.iq_phase_deg)
        i, q = x.real, x.imag
        x = i + 1j * g * (q * np.cos(phi) + i * np.sin(phi))

    if imp.quant_bits > 0:
        step = imp.full_scale / (2 ** (imp.quant_bits - 1))
        q = np.round(x.real / step) * step + 1j * np.round(x.imag / step) * step
        lim = imp.full_scale
        x = np.clip(q.real, -lim, lim) + 1j * np.clip(q.imag, -lim, lim)

    return x.astype(np.complex64)


class ImpairedChannel:
    """Wrap any live channel so every exchange's RX passes through the
    impaired front end - the closed-loop counterpart of applying
    ``apply_rx_impairments`` to an offline capture."""

    def __init__(self, inner, imp: RxImpairments, adc_rate: float,
                 seed: int = 0):
        self.inner = inner
        self.imp = imp
        self.adc_rate = adc_rate
        self._seed = seed
        self._n = 0

    def exchange(self, kind, bits, tx_env, cw_us):
        rx = self.inner.exchange(kind, bits, tx_env, cw_us)
        self._n += 1
        return apply_rx_impairments(rx, self.imp, self.adc_rate,
                                    seed=self._seed + self._n)
