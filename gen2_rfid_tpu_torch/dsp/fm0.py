"""Coherent FM0 detection: RN16 slicing, EPC period estimation + slicing.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/fm0.py`` (the re-design of
``tag_decoder_impl::tag_detection_RN16`` :114-142 and
``tag_detection_EPC`` :145-193), batched over frames, with the optional
decision-directed channel tracking (``cfg.track_channel``) and the
per-decision reliabilities that CRC-guided recovery reads
(runtime/softfix.py).  The JAX package samples through 0/+-1 selection
matmuls (a TPU gather workaround); the port gathers the same samples.  The
position tables are rebuilt here in the reference's float32 arithmetic: the
``span = half / 100`` branch of the period grid (fm0.py:174-181) and the
float32 truncation order of the bit positions (fm0.py:189-193).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..utils import profiling
from .filters import magnitude


def _diff_decode(signs: torch.Tensor) -> torch.Tensor:
    """FM0 differential rule (tag_decoder_impl.cc:121-140), per row: 0 on
    repeat, 1 on flip, previous sign initialized to +1."""
    prev = torch.cat([torch.ones_like(signs[:, :1]), signs[:, :-1]], dim=1)
    return (signs != prev).to(torch.int32)


def _slice(d: torch.Tensor, h_est: torch.Tensor):
    """Coherent decision statistic Re(d * conj(h)) and its +-1 signs."""
    result = (d * torch.conj(h_est)[:, None]).real
    return result, torch.where(result > 0, 1, -1).to(torch.int32)


def _tracking(cfg: ReaderConfig) -> bool:
    return cfg.track_channel and cfg.mode != "compat"


@functools.lru_cache(maxsize=32)
def _half_bit_offsets(cfg: ReaderConfig, n_half: int):
    """Half-bit sample offsets round(j*T/2), j < n_half (fm0.py:125-150), and
    the span the slice needs, padded to a GRANULE multiple as the reference
    pads it (the span decides where a late index is clamped)."""
    from ..runtime.frames import GRANULE

    half = cfg.n_samples_tag_bit / 2.0
    offs = np.round(np.arange(n_half) * half).astype(np.int64)
    span = int(offs[-1]) + GRANULE
    span = -(-span // GRANULE) * GRANULE
    return offs, span


@functools.lru_cache(maxsize=32)
def _half_bit_offsets_device(cfg: ReaderConfig, n_half: int, device: torch.device):
    """``_half_bit_offsets`` with the offsets on a device, kept for the next
    decode."""
    offs, span = _half_bit_offsets(cfg, n_half)
    return profiling.to_device(offs, device), span


def _diff_samples(frames: torch.Tensor, index: torch.Tensor, cfg: ReaderConfig,
                  n_half: int) -> torch.Tensor:
    """(E, n_half/2) differential samples d_j = s[2j] - s[2j+1] at the
    half-bit offsets past each frame's (clamped) sync index."""
    offs, span = _half_bit_offsets_device(cfg, n_half, frames.device)
    w = frames.shape[1]
    start = torch.clamp(index.to(torch.int64), 0, w - span)
    pos = start[:, None] + offs[None, :]
    s = frames.gather(1, pos)
    return s[:, 0::2] - s[:, 1::2]


def rn16_detect_soft(frames: torch.Tensor, index: torch.Tensor,
                     h_est: torch.Tensor, cfg: ReaderConfig):
    """Decode 16 RN16 bits per frame + the decision margin
    mean(|result|) / |h|^2 (fm0.py:38-68).  frames (E, W) complex64.  With
    channel tracking the signs come from the tracked slicer; the margin
    stays against the preamble estimate."""
    d = _diff_samples(frames, index, cfg, cfg.rn16_half_bits)
    result, signs = _slice(d, h_est)
    if _tracking(cfg):
        signs, _ = _track_and_slice(d, h_est)
    h2 = h_est.real ** 2 + h_est.imag ** 2
    margin = result.abs().mean(dim=1) / torch.clamp(h2, min=1e-12)
    return _diff_decode(signs), margin


def rn16_detect(frame: torch.Tensor, index: torch.Tensor, h_est: torch.Tensor,
                cfg: ReaderConfig) -> torch.Tensor:
    """Decode the 16 RN16 bits of one synced frame (fm0.py:71-75): frame
    (W,) complex64, index and h_est its sync's scalars."""
    return rn16_detect_soft(frame[None], index.reshape(1), h_est.reshape(1), cfg)[0][0]


def payload_detect(frames: torch.Tensor, index: torch.Tensor, h_est: torch.Tensor,
                   cfg: ReaderConfig, n_bits: int) -> torch.Tensor:
    """Decode an n-bit FM0 payload per frame with the RN16 machinery
    (fm0.py:78-90): access-command replies such as Req_RN handles (32 bits)
    and Read data (33+16w bits).  Plain coherent slicing, no tracking."""
    _, signs = _slice(_diff_samples(frames, index, cfg, 2 * n_bits), h_est)
    return _diff_decode(signs)


def epc_period_grid(cfg: ReaderConfig, n_probe: int = None):
    """Half-period candidates (tag_decoder_impl.cc:151-166), float32 as the
    reference computes them; native mode widens via epc_grid_frac."""
    if n_probe is None:
        n_probe = 2 * (cfg.epc_bits - 1)
    if cfg.mode == "compat":
        frac, number_steps = 0.01, 20
    else:
        frac, number_steps = cfg.epc_grid_frac, cfg.epc_grid_steps
    half = np.float32(cfg.n_samples_tag_bit / 2.0)
    if frac == 0.01:
        span = half / np.float32(100.0)   # reference's exact f32 arithmetic
    else:
        span = half * np.float32(frac)
    lo, hi = half - span, half + span
    step = (hi - lo) / np.float32(number_steps - 1)
    cand = lo + np.arange(number_steps, dtype=np.float32) * step
    return cand, n_probe


@functools.lru_cache(maxsize=32)
def _bit_position_tables(cfg: ReaderConfig):
    """(steps, n_bits) first/second half-bit offsets per candidate period,
    relative to the sync index, in the reference's float32 truncation order
    (tag_decoder_impl.cc:171-173), and the span they cover."""
    cand, _ = epc_period_grid(cfg)
    j = np.arange(cfg.epc_data_bits, dtype=np.float32)
    i1 = (j[None, :] * (2.0 * cand[:, None])).astype(np.int32)
    i2 = (j[None, :] * (2.0 * cand[:, None]) + cand[:, None]).astype(np.int32)
    span = int(max(i1.max(), i2.max())) + 1
    return i1.astype(np.int64), i2.astype(np.int64), span


@functools.lru_cache(maxsize=32)
def _energy_positions(cfg: ReaderConfig):
    """(steps, n_probe) energy probe offsets floor(i * T_t) per candidate
    (tag_decoder_impl.cc:157-164) and the probe extent k (fm0.py:219-235)."""
    cand, n_probe = epc_period_grid(cfg)
    k = int(np.floor(np.float32(n_probe - 1) * cand.max())) + 1
    pos = (np.arange(n_probe, dtype=np.float32)[None, :]
           * cand[:, None]).astype(np.int32)
    return pos.astype(np.int64), k


@functools.lru_cache(maxsize=32)
def _period_device(cfg: ReaderConfig, device: torch.device):
    """The period search's tables on a device, kept for the next decode: the
    (steps, n_probe) int64 probe offsets, the (steps,) float32 candidates,
    and the (steps, n_bits) int64 bit positions ``_bit_position_tables``
    gives."""
    probes, _ = _energy_positions(cfg)
    cand, _ = epc_period_grid(cfg)
    i1, i2, _ = _bit_position_tables(cfg)
    return tuple(profiling.to_device(a, device) for a in (probes, cand, i1, i2))


def _energy_starts(index: torch.Tensor, w: int, cfg: ReaderConfig):
    """Where each frame's energy probes start (fm0.py:238-256, :300-313):
    with room to fold the sync offsets, b0 + clip(index - b0, 0, n_off-1);
    otherwise min(index, w - k), clamped at 0 as dynamic_slice clamps."""
    _, k = _energy_positions(cfg)
    n_off = cfg.sync_search
    b0 = int(cfg.tag_preamble_bits * cfg.n_samples_tag_bit
             + cfg.n_samples_tag_bit / 2.0)
    if b0 + n_off - 1 + k <= w:
        return b0 + torch.clamp(index.to(torch.int64) - b0, 0, n_off - 1)
    return torch.clamp(torch.clamp(index.to(torch.int64), max=w - k), min=0)


def epc_period(magn2: torch.Tensor, index: torch.Tensor, cfg: ReaderConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_sel (E,), T_half (E,)): the period candidate with the most
    |frame|^2 energy at its probe positions past each index, first maximum
    (fm0.py:291-316).  magn2 (E, W) float32."""
    dev = magn2.device
    probes, cand, _, _ = _period_device(cfg, dev)
    e0 = _energy_starts(index, magn2.shape[1], cfg)
    epos = e0[:, None, None] + probes[None]
    energy = magn2[torch.arange(magn2.shape[0], device=dev)[:, None, None],
                   epos].sum(dim=2)                       # (E, steps)
    t_sel = torch.argmax(energy, dim=1)
    return t_sel, cand[t_sel]


def epc_diff_samples(frames: torch.Tensor, index: torch.Tensor, t_sel: torch.Tensor,
                     cfg: ReaderConfig) -> torch.Tensor:
    """Differential samples (E, ..., n_bits) at period t_sel's truncated
    positions past each (clamped) index (fm0.py:318-337), for frames
    (E, ..., W): a diversity decode's channels share an index and period."""
    _, _, span = _bit_position_tables(cfg)
    _, _, i1, i2 = _period_device(cfg, frames.device)
    # dynamic_slice semantics: the start is clamped into [0, w - span].
    sl_start = torch.clamp(index.to(torch.int64), 0, frames.shape[-1] - span)

    def at(tab):
        p = sl_start[:, None] + tab[t_sel]                                # (E, n_bits)
        p = p.reshape((p.shape[0],) + (1,) * (frames.dim() - 2) + (p.shape[1],))
        return frames.gather(-1, p.expand(frames.shape[:-1] + (p.shape[-1],)))

    return at(i1) - at(i2)


def epc_detect_soft(frames: torch.Tensor, magn2: torch.Tensor, index: torch.Tensor,
                    h_est: torch.Tensor, cfg: ReaderConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode the EPC payload bits per frame, with per-decision
    reliabilities (fm0.py:259-344).

    The symbol period is ``epc_period``'s; the bits are the differential
    samples at that period's truncated positions, sliced coherently (or by
    the tracked slicer).  Returns (bits, T_half, rel (E, n_bits)) where
    rel[:, j] is the |decision statistic| of differential sample j."""
    t_sel, t_half = epc_period(magn2, index, cfg)
    d = epc_diff_samples(frames, index, t_sel, cfg)
    if _tracking(cfg):
        signs, rel = _track_and_slice(d, h_est)
    else:
        result, signs = _slice(d, h_est)
        rel = result.abs()
    return _diff_decode(signs), t_half, rel


def epc_detect(frame: torch.Tensor, magn2: torch.Tensor, index: torch.Tensor,
               h_est: torch.Tensor, cfg: ReaderConfig):
    """Decode the EPC payload bits of one synced frame (fm0.py:259-274):
    (bits (epc_bits,), T_half estimate); magn2 is |frame - dc|^2."""
    bits, t_half, _ = epc_detect_soft(frame[None], magn2[None], index.reshape(1),
                                      h_est.reshape(1), cfg)
    return bits[0], t_half[0]


def _seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (one order on every device)."""
    out = v[..., 0]
    for j in range(1, v.shape[-1]):
        out = out + v[..., j]
    return out


def _track_and_slice(d: torch.Tensor, h_est: torch.Tensor, seg: int = 4):
    """Decision-directed channel tracking over frames (fm0.py:347-400).

    d (E, n) differential samples are sliced in ``seg``-sample segments with
    the running channel estimate; each segment then rotates the estimate
    toward the decision-aligned mean of its confident samples
    (|d|^2 > |h|^2 / 4), keeping |h|: h <- normalize(h/2 + normalize(u)/2).
    One Python step per segment (32 for a 128-bit EPC).  The arithmetic is
    written out in real float32 ops with sequential segment sums and
    correctly rounded roots, so CPU and CUDA slice alike.

    Returns (signs (E, n) int32 +-1, rel (E, n) float32), rel the |decision
    statistic| against the running h."""
    e, n = d.shape
    pad = (-n) % seg
    dr, di = d.real, d.imag
    if pad:
        dr = torch.cat([dr, dr.new_zeros((e, pad))], dim=1)
        di = torch.cat([di, di.new_zeros((e, pad))], dim=1)
    hr, hi = h_est.real, h_est.imag
    signs, rels = [], []
    for k in range(0, n + pad, seg):
        a, b = dr[:, k: k + seg], di[:, k: k + seg]
        r = a * hr[:, None] + b * hi[:, None]
        s = torch.where(r > 0, 1.0, -1.0)
        h2 = hr * hr + hi * hi
        cf = ((a * a + b * b) > 0.25 * h2[:, None]).to(torch.float32)
        den = _seq_sum(cf)
        dd = torch.clamp(den, min=1.0)
        ur = _seq_sum(a * s * cf) / dd
        ui = _seq_sum(b * s * cf) / dd
        mag_h = magnitude(hr, hi)
        g = mag_h / torch.clamp(magnitude(ur, ui), min=1e-20)
        br = 0.5 * hr + 0.5 * (ur * g)
        bi = 0.5 * hi + 0.5 * (ui * g)
        g = mag_h / torch.clamp(magnitude(br, bi), min=1e-20)
        upd = den > 0.5
        hr = torch.where(upd, br * g, hr)
        hi = torch.where(upd, bi * g, hi)
        signs.append(s)
        rels.append(r.abs())
    s_all = torch.cat(signs, dim=1)[:, :n]
    return torch.where(s_all > 0, 1, -1).to(torch.int32), torch.cat(rels, dim=1)[:, :n]
