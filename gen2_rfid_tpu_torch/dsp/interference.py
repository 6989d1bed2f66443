"""Capture-level CW interferer cancellation (``cfg.cancel_cw``).

PyTorch counterpart of ``gen2_rfid_tpu/dsp/interference.py``.  Another
reader's carrier inside the listen channel is phase-continuous over the
whole capture, while backscatter exists only inside reply windows, so each
tone is estimated globally and subtracted before the front end:

1. coarse frequency from the peak of one full-capture FFT (pow2 length),
   with the bins within ``_DC_MASK_FRAC`` of the FFT length around DC
   masked (the wanted carrier sits at baseband 0);
2. refinement from the projection-phase advance between the two capture
   halves;
3. amplitude and phase by one least-squares projection;
4. a guard: cancel only when the peak exceeds ``min_excess_db`` over the
   median of the off-DC spectrum (every 16th bin).  A capture without a
   tone comes back bit for bit.

The median is ``torch.nanquantile(..., 0.5)``, which averages the two
middle values of an even count as ``jnp.nanmedian`` does
(``torch.nanmedian`` returns the lower one).  Phases are formed as the JAX
package forms them, in float32: ``((-2 pi) * f) * t``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .filters import f32_scalar

# Fraction of the FFT length around DC treated as the wanted carrier: at
# the default 2 Msps this masks +-20 kHz.
_DC_MASK_FRAC = 0.01


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _phase(f: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """exp(-2j*pi*f*t) with the phase rounded in float32 as the reference
    rounds it."""
    theta = (f32_scalar(-2.0 * math.pi, t.device) * f) * t
    return torch.complex(torch.cos(theta), torch.sin(theta))


def cancel_cw_planar(x2: torch.Tensor, n_tones: int = 1,
                     min_excess_db: float = 15.0) -> torch.Tensor:
    """Estimate and subtract up to ``n_tones`` strong CW tones from a planar
    (2, N) float32 capture (interference.py:54-101), on x2's device."""
    n = x2.shape[1]
    nf = _pow2(n)
    dev = x2.device
    f32 = torch.float32
    x = torch.complex(x2[0].to(f32), x2[1].to(f32))
    t = torch.arange(n, dtype=f32, device=dev)
    half = n // 2
    guard_lin = f32_scalar(10.0 ** (min_excess_db / 20.0), dev)
    k = torch.arange(nf, device=dev)
    dc_w = int(max(1, round(nf * _DC_MASK_FRAC)))
    near_dc = (k < dc_w) | (k >= nf - dc_w)
    two_pi_half = f32_scalar(2.0 * math.pi * half, dev)
    for _ in range(n_tones):
        mag = torch.fft.fft(x, n=nf).abs()
        magm = torch.where(near_dc, 0.0, mag)
        kpk = torch.argmax(magm)
        peak = magm[kpk]
        med = torch.nanquantile(torch.where(near_dc, torch.nan, mag)[::16], 0.5)
        accept = peak > guard_lin * med
        # Coarse normalized frequency (cycles/sample), signed; nf is a power
        # of two, so the division is exact.
        f0 = torch.where(kpk <= nf // 2, kpk, kpk - nf).to(f32) / nf
        z = x * _phase(f0, t)
        dphi = torch.angle(z[half: 2 * half].sum() * torch.conj(z[:half].sum()))
        f = f0 + dphi / two_pi_half
        e = _phase(f, t)
        c = (x * e).sum() / n
        x = x - torch.where(accept, c, 0) * torch.conj(e)
    return torch.stack([x.real, x.imag]).to(f32)


def cancel_cw(iq, n_tones: int = 1, min_excess_db: float = 15.0, device=None):
    """Host convenience: complex capture in and out, cancelled on CUDA
    unless ``device`` says otherwise."""
    from ..runtime.inventory import resolve_device

    iq = np.asarray(iq)
    x2 = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(np.float32))
    out = cancel_cw_planar(x2.to(resolve_device(device)), n_tones,
                           min_excess_db).cpu().numpy()
    return (out[0] + 1j * out[1]).astype(np.complex64)
