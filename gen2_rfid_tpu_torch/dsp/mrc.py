"""Maximal-ratio combining across RX channels (antenna diversity).

PyTorch counterpart of ``gen2_rfid_tpu/dsp/mrc.py``.  C time-aligned RX
channels of one air interface decode coherently:

* sync: the preamble correlation power sums over channels, so the peak
  survives a null on any one of them; each channel keeps its own h at the
  shared offset;
* detection: each channel's differential samples project onto its own h and
  the real parts add, the maximal-ratio statistic Σ_c Re(d_c conj(h_c));
* the EPC period search runs on |frame|^2 summed over channels.

Frames are (E, C, W) complex64, the JAX package's ``vmap`` over events of
per-event (C, W) functions.  Samples come from the single-channel position
tables (dsp/sync.py, dsp/fm0.py), where the JAX package contracts its
selection matrices.  Sums over channels run in channel order, so that CPU
and CUDA add alike.  FM0 only, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ReaderConfig
from . import fm0, sync


def chan_sum(v: torch.Tensor) -> torch.Tensor:
    """v[:, 0] + v[:, 1] + ... over the channel axis 1, in channel order."""
    out = v[:, 0]
    for c in range(1, v.shape[1]):
        out = out + v[:, c]
    return out


def tag_sync_mrc(frames: torch.Tensor, cfg: ReaderConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (E, C, W) -> (data_index (E,) int32, h_est (E, C) complex64):
    one offset per event from the channel-summed correlation power (first
    maximum), each channel's h there (mrc.py:35-60)."""
    power, h_all = sync.preamble_search(frames, cfg)          # (E, C, n_off)
    max_index = torch.argmax(chan_sum(power), dim=1)
    e, c, _ = h_all.shape
    h_est = h_all.gather(2, max_index[:, None, None].expand(e, c, 1))[..., 0]
    return (max_index + sync.data_shift(cfg)).to(torch.int32), h_est


def mrc_signs(d: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """d (E, C, K) differential samples, h (E, C) -> (signs (E, K) int32 +-1,
    statistic Σ_c Re(d_c conj(h_c)) (E, K)) (mrc.py:63-67)."""
    stat = chan_sum((d * torch.conj(h)[:, :, None]).real)
    return torch.where(stat > 0, 1, -1).to(torch.int32), stat


def rn16_detect_mrc(frames: torch.Tensor, index: torch.Tensor, h_est: torch.Tensor,
                    cfg: ReaderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, C, W) frames -> (bits (E, 16), margin (E,)) by the MRC statistic;
    margin = mean |stat| / Σ_c |h_c|^2 (mrc.py:70-82)."""
    e, c, w = frames.shape
    d = fm0._diff_samples(frames.reshape(e * c, w), index.repeat_interleave(c), cfg,
                          cfg.rn16_half_bits).reshape(e, c, -1)
    signs, stat = mrc_signs(d, h_est)
    h2 = chan_sum(h_est.real ** 2 + h_est.imag ** 2)
    margin = stat.abs().mean(dim=1) / torch.clamp(h2, min=1e-12)
    return fm0._diff_decode(signs), margin


def epc_detect_mrc(frames: torch.Tensor, magn2: torch.Tensor, index: torch.Tensor,
                   h_est: torch.Tensor, cfg: ReaderConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, C, W) frames and |.|^2 -> (bits (E, 128), t_half (E,)): the
    period from the channel-summed energy, MRC bit decisions (mrc.py:85-119)."""
    t_sel, t_half = fm0.epc_period(chan_sum(magn2), index, cfg)
    signs, _ = mrc_signs(fm0.epc_diff_samples(frames, index, t_sel, cfg), h_est)
    return fm0._diff_decode(signs), t_half
