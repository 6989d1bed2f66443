"""Front end and gate of the reference: y, and the command events found by
walking the gate's state machine over the capture, one run of samples at a
time."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GRANULE = 8          # a reply window starts at its event rounded down to this
_F64 = torch.float64


def front_taps(cfg) -> int:
    """Boxcar length matched to half an FM0 symbol or one Miller half-cycle
    at ADC rate (25 at 2 Msps FM0 40 kHz)."""
    return int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)


def front_y(x2: torch.Tensor, decim: int, n_taps: int,
            dtype: torch.dtype = _F64) -> torch.Tensor:
    """(2, N) ADC-rate I/Q -> complex128 y of N // decim samples:
    ``y[k] = sum(x[k*decim - n_taps + 1 .. k*decim])``, zeros before the
    capture.  The sums are float64.  ``dtype=torch.bfloat16`` is the
    control: the capture and y rounded to bfloat16, the sums in float32."""
    work = _F64 if dtype == _F64 else torch.float32
    x = x2.to(dtype).to(work)
    ny = x.shape[1] // decim
    xp = torch.cat([x.new_zeros((2, n_taps - 1)), x], dim=1)
    y2 = x.new_zeros((2, ny))
    for j in range(n_taps):
        y2 += xp[:, j: j + ny * decim: decim]
    y2 = y2.to(dtype).to(_F64)
    return torch.complex(y2[0], y2[1])


def above_threshold(y: torch.Tensor, win: int, frac: float) -> np.ndarray:
    """(Ny,) bool on the host: |y| above ``frac`` times the mean of |y| over
    the ``win`` samples ending at the same sample (zeros before the
    capture)."""
    amp = y.abs()
    c = torch.cat([amp.new_zeros(1), torch.cumsum(amp, 0)])
    i = torch.arange(1, amp.shape[0] + 1, device=amp.device)
    mean = (c[i] - c[torch.clamp(i - win, min=0)]) / win
    return (amp > frac * mean).cpu().numpy()


class Events(NamedTuple):
    """The command events: fixed-capacity table and the gate's counts."""

    index: torch.Tensor      # (max_events,) int32 window start; invalid rows hold Ny
    valid: torch.Tensor      # (max_events,) bool
    n_pulses: torch.Tensor   # (max_events,) int32 PIE pulses of the command
    dc: torch.Tensor         # (max_events,) complex128 mean of y before the event
    noise_var: torch.Tensor  # (max_events,) float64 power of y about that mean


def walk_gate(above: np.ndarray, pw_half: int, nt1: int, min_pulses: int):
    """The gate's state machine over the samples, stepped a run of equal
    samples at a time: (trigger samples, pulses of each trigger's command).

    A rise (a sample above after one below; the capture is preceded by
    silence) is a PIE pulse when at least ``pw_half + 1`` samples below
    precede it and it is not among the first ``pw_half`` samples; any
    other rise resets the count, and so does the carrier held above for
    ``nt1 + 1`` samples.  A pulse that brings the count past
    ``min_pulses`` and is followed by ``nt1 + 1`` samples of carrier
    triggers a reply window ``nt1 + 1`` samples after it."""
    n = above.shape[0]
    change = np.flatnonzero(above[1:] != above[:-1]) + 1
    starts = np.concatenate([[0], change]).tolist()
    ends = np.concatenate([change, [n]]).tolist()
    level = bool(above[0])
    below = 1
    count = 0
    trig, pulses = [], []
    for s, e in zip(starts, ends):
        if not level:
            below = e - s + (1 if s == 0 else 0)
            level = True
            continue
        run = e - s
        if s >= pw_half and below >= pw_half + 1:
            count += 1
            if count > min_pulses and run >= nt1 + 2:
                trig.append(s + nt1 + 1)
                pulses.append(count)
        else:
            count = 0
        if run >= nt1 + 1:
            count = 0
        level = False
    return trig, pulses


def gate_events(y: torch.Tensor, cfg, above: np.ndarray) -> Events:
    """The events of y: the gate's triggers in order, the first
    ``max_events`` kept; at each, the mean of the ``dc_length`` samples of
    y ending there (the window moved forward where the capture begins) and
    the mean power about it."""
    n = y.shape[0]
    dev = y.device
    trig, pulses = walk_gate(above, cfg.n_samples_pw // 2, cfg.n_samples_t1,
                             cfg.num_pulses_command)
    cap = cfg.max_events
    k = min(len(trig), cap)
    index = np.full(cap, n, dtype=np.int64)
    index[:k] = trig[:k]
    n_pulses = np.zeros(cap, dtype=np.int64)
    n_pulses[:k] = pulses[:k]
    w = cfg.dc_length
    start = np.clip(np.minimum(index, n - 1) - (w - 1), 0, None)
    dc = torch.zeros(cap, dtype=y.dtype, device=dev)
    nv = torch.zeros(cap, dtype=_F64, device=dev)
    for b in range(0, cap, 4096):
        st = torch.as_tensor(start[b: b + 4096], device=dev)
        win = y[st[:, None] + torch.arange(w, device=dev)[None, :]]
        m = win.mean(dim=1)
        dc[b: b + 4096] = m
        nv[b: b + 4096] = torch.clamp((win - m[:, None]).abs().square().mean(dim=1),
                                      min=1e-12)
    index_t = torch.as_tensor(index, dtype=torch.int32, device=dev)
    return Events(index=index_t, valid=index_t < n,
                  n_pulses=torch.as_tensor(n_pulses, dtype=torch.int32, device=dev),
                  dc=dc, noise_var=nv)
