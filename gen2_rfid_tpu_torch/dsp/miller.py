"""Miller-M subcarrier demodulation: preamble sync and the segment cascade.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/miller.py``.  Every function
takes a frame batch (B, W) complex64; the JAX package's ``*_batch`` and
``*_eps_batch`` forms are these functions, the sync's eps passed as ``eps0``.

* ``miller_sync_full``: the preamble correlation over n_eps clock-error
  hypotheses x n_off offsets is one matmul against the dense (span,
  n_eps*n_off) +-1 table the JAX package contracts (miller.py:67-95).  It
  runs in float64 and rounds once to float32, so that CPU and CUDA get the
  same correlations.  The winner is ``torch.argmax`` over the flattened
  (eps-major) power, the first index on ties as ``jnp.argmax``; where the
  JAX package contracts one-hot vectors (sums of exact zeros) the port
  indexes.
* ``miller_detect``: the drift-tracking joint (offset, chip-period) segment
  cascade (miller.py:253-444), one Python step per segment over the whole
  batch.  Each segment's slice starts on the granule, as in the JAX
  package; where it contracts a dense selection table (0.9% nonzero), the
  port gathers the m chips of every (period, offset, half-bit) hypothesis
  at tabulated positions and sums them with the subcarrier sign in chip
  order.  Sums over the small axes are written out as adds, so CPU and
  CUDA round alike.  The priors' exponentials are taken in float64 and
  rounded to float32: the offset prior as an (8, n_off) host table by the
  granule remainder, the period prior on the device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..runtime.frames import GRANULE
from ..sim.tag import miller_chips
from ..utils import profiling
from .fm0 import _track_and_slice

_F32 = torch.float32
_F64 = torch.float64


def _preamble_pm(m: int, trext: int = 0) -> np.ndarray:
    """+-1 chip template of the Miller preamble (no data bits)."""
    chips = miller_chips(np.zeros(0, dtype=np.int64), m, add_dummy=False,
                         trext=trext)
    return chips.astype(np.float32) * 2.0 - 1.0


def sync_eps_grid(frac: float) -> np.ndarray:
    """Preamble-correlation clock-error hypotheses: +-frac in 0.5% steps
    (miller.py:40-52)."""
    n = max(int(round(2 * frac / 0.005)) + 1, 3)
    return np.linspace(-frac, frac, n).astype(np.float32)


def seg_eps_grid(frac: float) -> np.ndarray:
    """Joint-search chip-period hypotheses: +-frac in 1% steps
    (miller.py:55-64)."""
    n = max(int(round(2 * frac / 0.01)) + 1, 3)
    return np.linspace(-frac, frac, n).astype(np.float32)


def preamble_len_samples(cfg: ReaderConfig) -> int:
    """Nominal-clock preamble length in samples (miller.py:98-103)."""
    n_chips = _preamble_pm(cfg.miller_m, cfg.trext).shape[0]
    return int(round(n_chips * cfg.n_samples_chip))


def default_seg_bits(m: int) -> int:
    """Segment length (bits) of the cascade: 64 backscatter chips a segment
    (miller.py:233-250)."""
    return max(2, 32 // m)


# ---- sync -------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _sync_tables(cfg: ReaderConfig):
    """The JAX package's (span, n_eps*n_off) correlation table, and the
    positions and weights of its channel-mean table as gathers: chip j of
    hypothesis e sits at pos[e, j] + offset, weight pm[j] / n_chips."""
    m = cfg.miller_m
    pm = _preamble_pm(m, cfg.trext)
    n_chips = pm.shape[0]
    d = cfg.n_samples_chip
    n_off = cfg.sync_search
    eps_grid = sync_eps_grid(cfg.miller_grid_frac)
    n_eps = eps_grid.shape[0]
    span = max(int(np.floor((n_chips - 1) * d * (1.0 + e))) + n_off for e in eps_grid)
    s = np.zeros((span, n_eps * n_off), dtype=np.float32)
    pos = np.zeros((n_eps, n_chips), dtype=np.int64)
    dshift = np.zeros(n_eps, dtype=np.int64)
    offs = np.arange(n_off)
    for t, e in enumerate(eps_grid):
        pos[t] = np.floor(np.arange(n_chips) * d * (1.0 + e)).astype(np.int32)
        dshift[t] = int(round(n_chips * d * (1.0 + e)))
        for j in range(n_chips):
            np.add.at(s, (pos[t, j] + offs, t * n_off + offs), pm[j])
    weights = pm / np.float32(n_chips)
    return s, span, dshift, n_off, eps_grid, pos, weights


@functools.lru_cache(maxsize=8)
def _sync_device(cfg: ReaderConfig, device: torch.device):
    """The sync tables on a device, kept for the next decode (the float64
    correlation table is 67 MB at M=8 TRext, 8 Msps, decim 2)."""
    s, span, dshift, n_off, eps_grid, pos, weights = _sync_tables(cfg)

    def t(a, dtype=None):
        return profiling.to_device(a, device, dtype)

    return (t(s, _F64), span, t(dshift), n_off, t(eps_grid), t(pos),
            t(weights.astype(np.float64)))


def _dot64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of float32 x times float64 w, in float64
    (exact products), rounded once to float32."""
    return (x.to(_F64) * w).sum(dim=-1).to(_F32)


def miller_sync_full(frames: torch.Tensor, cfg: ReaderConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Locate the Miller preamble in each frame (miller.py:106-140).

    Returns (data_index (B,) int32, the first data chip's sample under the
    winning hypothesis; h_est (B,) complex64; eps_sync (B,) float32, the
    winning chip-period error, which seeds the segment cascade)."""
    s, span, dshift, n_off, eps_grid, pos, weights = _sync_device(cfg, frames.device)
    if frames.shape[1] < span:
        raise ValueError(f"miller_sync: frames of {frames.shape[1]} samples, the "
                         f"preamble search needs {span}")
    x = frames[:, :span]
    cr = torch.matmul(x.real.to(_F64), s).to(_F32)
    ci = torch.matmul(x.imag.to(_F64), s).to(_F32)
    power = cr * cr + ci * ci
    best = torch.argmax(power, dim=1)
    t = best // n_off
    o = best % n_off
    chips = frames.gather(1, pos[t] + o[:, None])          # (B, n_chips)
    h_est = torch.complex(_dot64(chips.real, weights), _dot64(chips.imag, weights))
    data_index = (o + dshift[t]).to(torch.int32)
    return data_index, h_est, eps_grid[t]


def miller_sync(frames: torch.Tensor, cfg: ReaderConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(data_index, h_est) of ``miller_sync_full``."""
    data_index, h_est, _ = miller_sync_full(frames, cfg)
    return data_index, h_est


# ---- the segment cascade ------------------------------------------------------

@functools.lru_cache(maxsize=32)
def segment_positions(cfg: ReaderConfig, n_bits: int, seg_bits: int, off_chips: float):
    """The JAX package's per-segment selection tables (miller.py:151-230) as
    positions.  Returns (((s0, span, rel), ...), eps grid, offsets): rel is
    an (n_eps, n_off, 2*sg, m) int64 table of the sample, relative to the
    segment's slice start s0, that chip a of half-bit h reads under
    chip-period hypothesis e and start offset o (sg = the segment's bits;
    the tail segment covers only the bits that exist).  span is the slice
    length, padded to a GRANULE multiple; the offsets (samples) reach
    GRANULE past the symmetric +-off_chips grid to absorb the slice's
    granule remainder, in steps of 1, 0.5 or 0.25 samples by chip period.
    Chips of one column never share a sample, so the gathered sums hold the
    selection table's terms."""
    m = cfg.miller_m
    d = float(cfg.n_samples_chip)
    n_seg = (n_bits + seg_bits - 1) // seg_bits
    eps = seg_eps_grid(cfg.miller_grid_frac)
    step = 1.0 if d >= 8 else (0.5 if d >= 4 else 0.25)
    n_pts = int(np.ceil((2 * off_chips * d + GRANULE) / step)) + 1
    offsets = -off_chips * d + step * np.arange(n_pts)           # float64
    period = d * (1.0 + eps.astype(np.float64))
    tables = []
    for g in range(n_seg):
        sg = min(seg_bits, n_bits - g * seg_bits)
        k = np.arange(2 * sg * m, dtype=np.float64)
        base = g * (2.0 * seg_bits * m) * d
        pos = np.floor(base + offsets[None, :, None]
                       + k[None, None, :] * period[:, None, None]).astype(np.int64)
        s0 = int(pos.min())
        span = int(pos.max()) - s0 + 1
        span = -(-span // GRANULE) * GRANULE
        rel = (pos - s0).reshape(eps.shape[0], n_pts, 2 * sg, m)
        tables.append((s0, span, rel))
    return tuple(tables), eps, offsets.astype(np.float32)


@functools.lru_cache(maxsize=32)
def offset_prior_table(cfg: ReaderConfig, n_bits: int, seg_bits: int,
                       off_chips: float) -> np.ndarray:
    """(GRANULE, n_off) float32 offset prior by the slice's granule remainder
    (miller.py:367-370): a Gaussian of sigma 1.25 chips centred on the
    remainder, zero beyond off_chips + 0.26/d of it.  The argument is
    rounded in float32 as the JAX package rounds it; the exponential is
    taken in float64 and rounded once."""
    _, _, off_np = segment_positions(cfg, n_bits, seg_bits, off_chips)
    d = np.float32(cfg.n_samples_chip)
    off_chips_grid = off_np / float(d)
    lim = np.float32(off_chips + 0.26 / d)
    out = np.zeros((GRANULE, off_np.shape[0]), dtype=np.float32)
    for rem in range(GRANULE):
        rel = off_chips_grid - np.float32(rem) / d
        z = -(rel * rel) / np.float32(2.0 * 1.25 ** 2)
        out[rem] = np.where(np.abs(rel) <= lim,
                            np.exp(z.astype(np.float64)).astype(np.float32), 0.0)
    return out


@functools.lru_cache(maxsize=32)
def _cascade_device(cfg: ReaderConfig, n_bits: int, seg_bits: int, off_chips: float,
                    device: torch.device):
    tables, eps, offsets = segment_positions(cfg, n_bits, seg_bits, off_chips)
    segs = tuple((s0, span, rel.shape[2], profiling.to_device(rel.reshape(-1), device))
                 for s0, span, rel in tables)
    prior = offset_prior_table(cfg, n_bits, seg_bits, off_chips)
    return (segs, profiling.to_device(eps, device),
            profiling.to_device(offsets, device), profiling.to_device(prior, device))


def _sum_last(v: torch.Tensor, sign_alternates: bool = False) -> torch.Tensor:
    """v[..., 0] + v[..., 1] + ... left to right; with ``sign_alternates``
    the odd terms are subtracted (the subcarrier sign (-1)^a)."""
    out = v[..., 0]
    for a in range(1, v.shape[-1]):
        out = out - v[..., a] if sign_alternates and a % 2 else out + v[..., a]
    return out


def miller_detect(frames: torch.Tensor, index: torch.Tensor, h_est: torch.Tensor,
                  cfg: ReaderConfig, n_bits: int, seg_bits: int = None,
                  off_chips: float = 1.5, eps0: torch.Tensor = None):
    """Decode n_bits Miller-M bits a frame with the drift-tracking joint
    (offset, chip-period) segment cascade (miller.py:253-444).

    Each segment's slice starts at ``raw = clip(index + s0 + round(pred), 0,
    W - span)`` rounded down to the granule; the offset grid is relative to
    that start, its prior centred at the remainder and masked beyond
    off_chips.  The winner of energy x prior (first index on ties) gives the
    segment's half-bit correlations, its period the tracked chip-period error
    (slew-limited to 1% a segment, seeded by ``eps0`` or acquired cold in
    segment 0 when it is None), its offset the measured drift; the next
    segment's start extrapolates the drift with a slope clamped to 0.75 chip
    around the tracked period's.  Then each half-bit is sliced against
    h_est, or by the decision-directed tracker (fm0._track_and_slice on
    q * 2/m) when ``cfg.track_channel`` is set outside compat, and bit j is
    whether half-bits 2j and 2j+1 differ.

    Returns (bits (B, n_bits) int32, chip_est (B,) float32, margin (B,)
    float32, rel_bits (B, n_bits) float32)."""
    m = cfg.miller_m
    if seg_bits is None:
        seg_bits = default_seg_bits(m)
    dev = frames.device
    segs, eps_vals, off_vals, off_prior = _cascade_device(cfg, n_bits, seg_bits,
                                                          off_chips, dev)
    n_eps, n_off = eps_vals.shape[0], off_vals.shape[0]
    b, w = frames.shape
    rows = torch.arange(b, device=dev)
    idx = index.to(torch.int64)

    def f32(v):
        return profiling.to_device(v, dev, _F32)

    d = np.float32(cfg.n_samples_chip)
    d_t = f32(d)
    seg_chips = f32(2 * seg_bits * m)          # a full segment's chips
    max_step = f32(np.float32(0.75) * d)
    eps_slew = f32(0.01)
    sigma = np.float32(0.015)
    two_sigma2 = f32(np.float32(2.0) * (sigma * sigma))
    pred = torch.zeros(b, dtype=_F32, device=dev)
    prev = torch.zeros_like(pred)
    eps_track = eps0
    q_segs = []
    for g, (s0, span, n_half, rel) in enumerate(segs):
        if span > w:
            raise ValueError(f"miller_detect: frames of {w} samples, segment {g} "
                             f"spans {span}")
        shift = torch.round(pred).to(torch.int64)
        raw = torch.clamp(idx + s0 + shift, 0, w - span)
        row0 = raw // GRANULE
        rem = raw - row0 * GRANULE
        sl = frames.gather(1, (row0 * GRANULE)[:, None]
                           + torch.arange(span, device=dev)[None, :])
        v = sl[:, rel].reshape(b, n_eps, n_off, n_half, m)
        q = _sum_last(v, sign_alternates=True)                  # (B, E, O, 2sg)
        e = _sum_last(q.real * q.real + q.imag * q.imag)        # (B, E, O)
        if eps_track is None:
            prior = off_prior[rem][:, None, :]
        else:
            de = eps_vals[None, :] - eps_track[:, None]
            eps_prior = torch.exp((-(de * de) / two_sigma2).to(_F64)).to(_F32)
            prior = eps_prior[:, :, None] * off_prior[rem][:, None, :]
        best = torch.argmax((e * prior).reshape(b, n_eps * n_off), dim=1)
        be, bo = best // n_off, best % n_off
        q_segs.append(q[rows, be, bo])
        eps_meas = eps_vals[be]
        eps_track = eps_meas if eps_track is None else torch.minimum(
            torch.maximum(eps_meas, eps_track - eps_slew), eps_track + eps_slew)
        drift = (row0 * GRANULE - idx - s0).to(_F32) + off_vals[bo]
        slope_eps = eps_track * seg_chips * d_t
        if g == 0:
            slope = slope_eps
        else:
            slope = torch.minimum(torch.maximum(drift - prev, slope_eps - max_step),
                                  slope_eps + max_step)
        pred = drift + slope
        prev = drift

    q = torch.cat(q_segs, dim=1)[:, : 2 * n_bits]
    hr, hi = h_est.real[:, None], h_est.imag[:, None]
    stat = q.real * hr + q.imag * hi                       # Re(q * conj(h))
    if cfg.track_channel and cfg.mode != "compat":
        s, rel_half = _track_and_slice(q * (2.0 / m), h_est)
        s = s.to(_F32)
    else:
        s = torch.sign(stat)
        rel_half = stat.abs()
    bits = (s[:, 0::2] != s[:, 1::2]).to(torch.int32)
    rel_bits = torch.minimum(rel_half[:, 0::2], rel_half[:, 1::2])
    h2 = h_est.real * h_est.real + h_est.imag * h_est.imag
    margin = stat.abs().mean(dim=1) / torch.clamp(0.5 * m * h2, min=1e-12)
    chip_est = d_t * (1.0 + eps_track)
    return bits, chip_est, margin, rel_bits


def miller_rn16(frames, index, h, cfg, eps0=None):
    """Bits of a 16-bit RN16."""
    return miller_detect(frames, index, h, cfg, 16, eps0=eps0)[0]


def miller_rn16_soft(frames, index, h, cfg, eps0=None):
    """(bits, margin) of a 16-bit RN16."""
    bits, _, margin, _ = miller_detect(frames, index, h, cfg, 16, eps0=eps0)
    return bits, margin


def miller_epc(frames, index, h, cfg, eps0=None):
    """(bits, chip_est) of the EPC payload."""
    bits, chip, _, _ = miller_detect(frames, index, h, cfg, cfg.epc_data_bits, eps0=eps0)
    return bits, chip


def miller_epc_soft(frames, index, h, cfg, eps0=None):
    """(bits, chip_est, rel_bits): per-bit reliabilities for
    runtime/softfix.py (Miller errors are single-bit flips)."""
    bits, chip, _, rel = miller_detect(frames, index, h, cfg, cfg.epc_data_bits,
                                       eps0=eps0)
    return bits, chip, rel
