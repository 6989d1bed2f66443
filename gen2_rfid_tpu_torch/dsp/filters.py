"""Matched filter + decimation, the windowed sums and their mean, and |y|.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/filters.py``.  The matched filter
keeps GNU Radio's history convention: ``ntaps-1`` zeros precede the first
input, so ``y[k] = sum_j taps[j] * x[k*decim - (ntaps-1) + j]``, and the
output has ``N // decim`` samples.  Taps are summed in order j = 0..T-1, the
order of the fused front-end kernel (kernels/gate_front.py), so for the
boxcar taps of the main path the two agree bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import profiling


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


def _overlap_blocks(x: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """(nb, halo+block) overlapping rows of a 1-D tensor:
    ``ext[i] = x[i*block - halo : i*block + block]``, zero outside."""
    assert halo <= block, (halo, block)
    n = x.shape[0]
    nb = -(-n // block)
    blocks = torch.cat([x, x.new_zeros(nb * block - n)]).reshape(nb, block)
    tails = torch.cat([blocks.new_zeros((1, halo)), blocks[:-1, block - halo:]])
    return torch.cat([tails, blocks], dim=1)


def moving_sum(x: torch.Tensor, win: int, block: int = 8192) -> torch.Tensor:
    """Causal moving-window sum ``out[i] = sum(x[i-win+1 .. i])``, zero
    history: compat mode's blocked cumsum (filters.py:73-95), a running sum
    over each overlapping (halo + block) row and the difference of two of
    its entries.

    The running sum is taken in float64 and the difference rounded once to
    float32.  That is one definition on every device: the float64 partial
    sums of float32 inputs are exact while a row's values span less than
    2^15 in magnitude, and then the result is the correctly rounded window
    sum on CPU and CUDA alike.  XLA's float32 cumsum, which the JAX package
    runs, is neither: against this it differs by up to a few tens of float32
    ulps of the row's running sum (tests/test_torch_compat.py)."""
    x = x.to(torch.float32)
    n = x.shape[0]
    if n == 0:
        return x
    halo = max(win, 1)
    ext = _overlap_blocks(x, block, halo)
    c = torch.cumsum(ext, dim=1, dtype=torch.float64)
    ms = c[:, halo:] - c[:, halo - win: halo + block - win]
    return ms.to(torch.float32).reshape(-1)[:n]


@functools.lru_cache(maxsize=64)
def f32_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-d float32 tensor of ``value`` on a device, copied once per
    (value, device) and kept for the next decode."""
    return profiling.to_device(float(value), device, torch.float32)


def window_mean(s: torch.Tensor, win: int) -> torch.Tensor:
    """A windowed sum over ``win`` samples divided by ``win``: the gate's
    average.  The divisor is a float32 tensor, copied to ``s``'s device once
    per (win, device), so the division stays IEEE on CUDA (PyTorch turns
    division by a Python scalar into a reciprocal multiply there)."""
    return s / f32_scalar(win, s.device)


def moving_sum_complex(x: torch.Tensor, win: int) -> torch.Tensor:
    return torch.complex(moving_sum(x.real, win), moving_sum(x.imag, win))


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
