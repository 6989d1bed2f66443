"""Reply detection of the reference, one reply window a row, in float64:
the FM0 and Miller preamble syncs, the FM0 slicer with its period search,
and the Miller segment cascade.

The sample positions, search grids, priors and tie rule (the first
maximum) are the decoder's definitions and are computed as it states them
(the FM0 positions in float32, as the reference reader truncates its
float products); every sum over samples is float64."""

from __future__ import annotations

import numpy as np
import torch

from ..synth.config import TAG_PREAMBLE_BITS_PATTERN
from ..synth.sim.tag import miller_chips
from .front import GRANULE

_F64 = torch.float64
_I32 = torch.int32
_PREAMBLE = np.array(TAG_PREAMBLE_BITS_PATTERN)


def _first_max(v: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis."""
    hit = v == v.max(dim=-1, keepdim=True).values
    return torch.argmax(hit.to(torch.int8), dim=-1)


def _diff_decode(signs: torch.Tensor) -> torch.Tensor:
    """FM0's differential bits: 1 where a half-bit difference flips sign
    from the previous one, the sign before the first taken as +1."""
    prev = torch.cat([torch.ones_like(signs[:, :1]), signs[:, :-1]], dim=1)
    return (signs != prev).to(_I32)


def _slice(d: torch.Tensor, h: torch.Tensor):
    stat = (d * torch.conj(h)[:, None]).real
    return stat, torch.where(stat > 0, 1, -1)


# ---- FM0 ---------------------------------------------------------------------

def fm0_sync(frames: torch.Tensor, cfg):
    """(data index, h_est) of each window: the offset in ``[0,
    sync_search)`` where the preamble's +-1 half-bit pattern correlates
    with the most power (first maximum); the channel the mean of the
    preamble's high half-bits there; the data half a bit past the
    preamble."""
    half = cfg.n_samples_tag_bit / 2.0
    pm = _PREAMBLE * 2.0 - 1.0
    n_hb = cfg.preamble_half_bits
    hb = np.floor(np.arange(n_hb) * half).astype(np.int64)
    dev = frames.device
    offs = torch.arange(cfg.sync_search, device=dev)
    x = frames[:, torch.as_tensor(hb, device=dev)[:, None] + offs[None, :]]  # (B, n_hb, n_off)
    corr = (x * torch.as_tensor(pm[:n_hb], dtype=_F64, device=dev)[:, None]).sum(dim=1)
    best = _first_max(corr.real ** 2 + corr.imag ** 2)
    high = torch.as_tensor(np.flatnonzero(_PREAMBLE[:n_hb] == 1), device=dev)
    rows = torch.arange(frames.shape[0], device=dev)
    h = x[rows[:, None], high[None, :], best[:, None]].mean(dim=1)
    shift = int(cfg.tag_preamble_bits * cfg.n_samples_tag_bit + cfg.n_samples_tag_bit / 2.0)
    return best + shift, h


def fm0_rn16(frames, index, h, cfg):
    """(16 bits, margin) of each RN16 window: the half-bits at
    ``round(k * half)`` from the data index, the difference of each bit's
    two halves sliced against h; margin the mean |statistic| over |h|^2."""
    n_half = cfg.rn16_half_bits
    offs = np.round(np.arange(n_half) * (cfg.n_samples_tag_bit / 2.0)).astype(np.int64)
    span = -(-(int(offs[-1]) + GRANULE) // GRANULE) * GRANULE
    start = torch.clamp(index, 0, frames.shape[1] - span)
    s = frames.gather(1, start[:, None] + torch.as_tensor(offs, device=frames.device)[None, :])
    stat, signs = _slice(s[:, 0::2] - s[:, 1::2], h)
    margin = stat.abs().mean(dim=1) / torch.clamp(h.abs() ** 2, min=1e-12)
    return _diff_decode(signs), margin


def period_grid(cfg) -> np.ndarray:
    """The EPC half-period candidates (float32): ``epc_grid_steps`` evenly
    spaced over +-``epc_grid_frac`` of the nominal half bit."""
    f32 = np.float32
    half = f32(cfg.n_samples_tag_bit / 2.0)
    frac = cfg.epc_grid_frac
    span = half / f32(100.0) if frac == 0.01 else half * f32(frac)
    lo, hi = half - span, half + span
    step = (hi - lo) / f32(cfg.epc_grid_steps - 1)
    return lo + np.arange(cfg.epc_grid_steps, dtype=f32) * step


def fm0_epc(frames, index, h, cfg):
    """(bits, T_half) of each EPC window: the candidate half period whose
    probe positions ``trunc(p * T)`` (p < 2 * (epc_bits - 1)) hold the most
    power (first maximum), probed from the data index (held inside the
    sync's search range); then bit j from the samples at ``trunc(2jT)`` and
    ``trunc(2jT + T)``, differenced and sliced against h."""
    f32 = np.float32
    dev = frames.device
    cand = period_grid(cfg)
    n_probe = 2 * (cfg.epc_bits - 1)
    k = int(np.floor(f32(n_probe - 1) * cand.max())) + 1
    probes = (np.arange(n_probe, dtype=f32)[None, :] * cand[:, None]).astype(np.int64)
    w = frames.shape[1]
    b0 = int(cfg.tag_preamble_bits * cfg.n_samples_tag_bit + cfg.n_samples_tag_bit / 2.0)
    if b0 + cfg.sync_search - 1 + k <= w:
        e0 = b0 + torch.clamp(index - b0, 0, cfg.sync_search - 1)
    else:
        e0 = torch.clamp(torch.clamp(index, max=w - k), min=0)
    power = frames.real ** 2 + frames.imag ** 2
    pos = e0[:, None, None] + torch.as_tensor(probes, device=dev)[None]
    probed = power.gather(1, pos.reshape(pos.shape[0], -1)).reshape(pos.shape)
    sel = _first_max(probed.sum(dim=2))
    j = np.arange(cfg.epc_data_bits, dtype=f32)[None, :]
    i1 = (j * (f32(2.0) * cand[:, None])).astype(np.int64)
    i2 = (j * (f32(2.0) * cand[:, None]) + cand[:, None]).astype(np.int64)
    span = int(max(i1.max(), i2.max())) + 1
    start = torch.clamp(index, 0, w - span)

    def at(tab):
        return frames.gather(1, start[:, None] + torch.as_tensor(tab, device=dev)[sel])

    _, signs = _slice(at(i1) - at(i2), h)
    return _diff_decode(signs), torch.as_tensor(cand, device=dev)[sel].to(_F64)


# ---- Miller ------------------------------------------------------------------

def _eps_grid(frac: float, step: float) -> np.ndarray:
    """Clock-error hypotheses: +-frac in steps of about ``step`` (float32)."""
    return np.linspace(-frac, frac, max(int(round(2 * frac / step)) + 1, 3)).astype(np.float32)


def miller_sync(frames: torch.Tensor, cfg):
    """(data index, h_est, clock error) of each window: over the clock-error
    grid (steps of 0.005) and the offsets ``[0, sync_search)``, the
    preamble's +-1 chips at ``floor(j * d * (1 + e))`` correlated with the
    window, the pair with the most power (first maximum); the channel the
    chips' mean, each weighted by its template sign; the data index the
    preamble's length at that clock past the offset."""
    m = cfg.miller_m
    pm = miller_chips(np.zeros(0, dtype=np.int64), m, add_dummy=False,
                      trext=cfg.trext).astype(np.float64) * 2.0 - 1.0
    n_chips = pm.shape[0]
    d = cfg.n_samples_chip
    eps = _eps_grid(cfg.miller_grid_frac, 0.005)
    pos = np.stack([np.floor(np.arange(n_chips) * d * (1.0 + e)) for e in eps]).astype(np.int64)
    dshift = np.array([int(round(n_chips * d * (1.0 + e))) for e in eps], dtype=np.int64)
    dev = frames.device
    n_off = cfg.sync_search
    offs = torch.arange(n_off, device=dev)
    pm_t = torch.as_tensor(pm, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    x = frames[:, pos_t[:, :, None] + offs[None, None, :]]      # (B, n_eps, n_chips, n_off)
    corr = (x * pm_t[None, None, :, None]).sum(dim=2)           # (B, n_eps, n_off)
    best = _first_max((corr.real ** 2 + corr.imag ** 2).reshape(frames.shape[0], -1))
    t, o = best // n_off, best % n_off
    rows = torch.arange(frames.shape[0], device=dev)
    chips = x[rows, t, :, o]                                    # (B, n_chips)
    h = (chips * pm_t[None, :]).sum(dim=1) / n_chips
    eps_t = torch.as_tensor(eps, device=dev).to(_F64)
    return o + torch.as_tensor(dshift, device=dev)[t], h, eps_t[t]


def _segments(cfg, n_bits: int, seg_bits: int, off_chips: float):
    """Per segment (first sample s0, span, (n_eps, n_off, 2*sg, m) sample
    offsets from s0), the clock grid (steps of 0.01), the start offsets in
    samples, and the (GRANULE, n_off) offset prior: a Gaussian of 1.25 chips
    about the predicted start, by where that start falls in its granule,
    cut at ``off_chips`` (and a quarter sample)."""
    m = cfg.miller_m
    d = float(cfg.n_samples_chip)
    eps = _eps_grid(cfg.miller_grid_frac, 0.01)
    step = 1.0 if d >= 8 else (0.5 if d >= 4 else 0.25)
    n_pts = int(np.ceil((2 * off_chips * d + GRANULE) / step)) + 1
    offsets = -off_chips * d + step * np.arange(n_pts)
    period = d * (1.0 + eps.astype(np.float64))
    segs = []
    for g in range(-(-n_bits // seg_bits)):
        sg = min(seg_bits, n_bits - g * seg_bits)
        kk = np.arange(2 * sg * m, dtype=np.float64)
        pos = np.floor(g * (2.0 * seg_bits * m) * d + offsets[None, :, None]
                       + kk[None, None, :] * period[:, None, None]).astype(np.int64)
        s0 = int(pos.min())
        span = -(-(int(pos.max()) - s0 + 1) // GRANULE) * GRANULE
        segs.append((s0, span, (pos - s0).reshape(eps.shape[0], n_pts, 2 * sg, m)))
    d32 = np.float32(cfg.n_samples_chip)
    off_chip = offsets.astype(np.float32) / float(d32)
    lim = off_chips + 0.26 / float(d32)
    prior = np.zeros((GRANULE, n_pts), dtype=np.float64)
    for rem in range(GRANULE):
        rel = off_chip.astype(np.float64) - rem / float(d32)
        prior[rem] = np.where(np.abs(rel) <= lim, np.exp(-(rel * rel) / (2.0 * 1.25 ** 2)), 0.0)
    return segs, eps, offsets, prior


def miller_detect(frames, index, h, cfg, n_bits: int, eps0, off_chips: float = 1.5):
    """(bits, chip period, margin) of each window: the reply cut into
    segments of 64 chips; each segment's start and clock chosen jointly
    over the grids (the most energy of its half-bit sums, weighted by a
    Gaussian of 0.015 about the tracked clock and the offset prior about
    the predicted start, first maximum); the clock tracked by at most 0.01
    a segment, the start predicted from the last two segments' drift, its
    slope within 0.75 chip of the clock's.  Each half-bit sum (the chips
    of the subcarrier, alternately signed) is sliced against h; bit j is
    whether half-bits 2j and 2j+1 differ."""
    m = cfg.miller_m
    seg_bits = max(2, 32 // m)
    dev = frames.device
    segs, eps_np, off_np, prior_np = _segments(cfg, n_bits, seg_bits, off_chips)
    eps_v = torch.as_tensor(eps_np, device=dev).to(_F64)
    off_v = torch.as_tensor(off_np, device=dev)
    off_prior = torch.as_tensor(prior_np, device=dev)
    sub = torch.as_tensor([(-1.0) ** a for a in range(m)], dtype=_F64, device=dev)
    n_eps, n_off = eps_v.shape[0], off_v.shape[0]
    b, w = frames.shape
    rows = torch.arange(b, device=dev)
    d = float(np.float32(cfg.n_samples_chip))
    seg_samples = 2 * seg_bits * m * d
    pred = torch.zeros(b, dtype=_F64, device=dev)
    prev = torch.zeros_like(pred)
    track = eps0
    q_segs = []
    for g, (s0, span, rel_np) in enumerate(segs):
        if span > w:
            raise ValueError(f"windows of {w} samples, segment {g} spans {span}")
        n_half = rel_np.shape[2]
        raw = torch.clamp(index + s0 + torch.round(pred).to(torch.int64), 0, w - span)
        a0 = (raw // GRANULE) * GRANULE
        rel = torch.as_tensor(rel_np, device=dev)
        v = frames.gather(1, (a0[:, None] + rel.reshape(1, -1)))
        q = (v.reshape(b, n_eps, n_off, n_half, m) * sub).sum(dim=-1)
        e = (q.real ** 2 + q.imag ** 2).sum(dim=-1)
        de = eps_v[None, :] - track[:, None]
        prior = (torch.exp(-(de * de) / (2.0 * 0.015 ** 2))[:, :, None]
                 * off_prior[raw - a0][:, None, :])
        best = _first_max((e * prior).reshape(b, -1))
        be, bo = best // n_off, best % n_off
        q_segs.append(q[rows, be, bo])
        track = torch.clamp(eps_v[be], track - 0.01, track + 0.01)
        drift = (a0 - index - s0).to(_F64) + off_v[bo]
        slope_eps = track * seg_samples
        if g == 0:
            slope = slope_eps
        else:
            slope = torch.clamp(drift - prev, slope_eps - 0.75 * d, slope_eps + 0.75 * d)
        pred = drift + slope
        prev = drift
    q = torch.cat(q_segs, dim=1)[:, : 2 * n_bits]
    stat = q.real * h.real[:, None] + q.imag * h.imag[:, None]
    s = torch.sign(stat)
    bits = (s[:, 0::2] != s[:, 1::2]).to(_I32)
    margin = stat.abs().mean(dim=1) / torch.clamp(0.5 * m * h.abs() ** 2, min=1e-12)
    return bits, d * (1.0 + track), margin
