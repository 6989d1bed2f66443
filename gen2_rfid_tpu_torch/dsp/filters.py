"""Matched filter + decimation, the dyadic windowed sum, and |y|.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/filters.py``.  The matched filter
keeps GNU Radio's history convention: ``ntaps-1`` zeros precede the first
input, so ``y[k] = sum_j taps[j] * x[k*decim - (ntaps-1) + j]``, and the
output has ``N // decim`` samples.  Taps are summed in order j = 0..T-1, the
order of the fused front-end kernel (kernels/gate_front.py), so for the
boxcar taps of the main path the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def matched_filter_decimate(iq: torch.Tensor, taps, decim: int) -> torch.Tensor:
    """Complex FIR + decimate.  iq: (N,) complex64 -> (N // decim,) complex64.

    Real taps (the FM0/Miller matched filters are real)."""
    taps = np.asarray(taps, dtype=np.float32)
    t = taps.shape[0]
    n_out = iq.shape[0] // decim
    x = torch.stack([iq.real, iq.imag]).to(torch.float32)
    xp = torch.cat([x.new_zeros((2, t - 1)), x], dim=1)     # zero history
    acc = x.new_zeros((2, n_out))
    for j in range(t):
        acc = acc + float(taps[j]) * xp[:, j: j + n_out * decim: decim]
    return torch.complex(acc[0], acc[1])


def boxcar_taps(n: int) -> np.ndarray:
    """The reference's matched filter: [1]*n (apps/reader.py:65)."""
    return np.ones(n, dtype=np.float32)


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """sqrt(re*re + im*im) in float32 with the sum and the root correctly
    rounded on every device: the products and the sum round in float32, the
    root is taken in float64 and rounded once (exact for a float32 sqrt).
    PyTorch's CPU float32 sqrt is not correctly rounded; the CUDA kernels use
    the IEEE ``__fsqrt_rn``, and this is what they are held against."""
    s = re * re + im * im
    return torch.sqrt(s.to(torch.float64)).to(torch.float32)


def run_sum(x01: torch.Tensor, win: int) -> torch.Tensor:
    """Causal windowed sum ``out[i] = sum(x[i-win+1 .. i])`` (zero history)
    in ``gen2_rfid_tpu/dsp/filters.py::run_sum``'s exact dyadic order:
    levels ``p_j = p_{j-1} + shift(p_{j-1}, 2^(j-1))``, then the set bits of
    ``win`` combined from the highest level down.  The native gate runs it on
    float amplitudes, where the order decides the rounding."""
    x = x01.to(torch.float32)

    def shifted(a, s):
        if not s:
            return a
        if s >= a.shape[0]:
            return torch.zeros_like(a)
        return torch.cat([a.new_zeros(s), a[:-s]])

    pows = [x]
    while (1 << len(pows)) <= win:
        p = pows[-1]
        pows.append(p + shifted(p, 1 << (len(pows) - 1)))
    out = None
    off = 0
    for j in reversed(range(len(pows))):
        if win & (1 << j):
            term = shifted(pows[j], off)
            out = term if out is None else out + term
            off += 1 << j
    return out
