"""Frame sync: FM0 preamble correlation and channel estimation, batched.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/sync.py`` (``tag_sync``, the
re-design of ``tag_decoder_impl::tag_sync``, tag_decoder_impl.cc:78-109).
Where the JAX package contracts selection matrices (a TPU gather
workaround), the port gathers the same samples directly: the correlation
over 15 offsets x 12 half-bits and the 6-chip channel mean use the
reference's positions, argmax takes the first maximum.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import TAG_PREAMBLE_BITS_PATTERN, ReaderConfig
from ..utils import profiling

# +-1 correlation template (tag_decoder_impl.cc:102).
_PREAMBLE_PM = np.array(TAG_PREAMBLE_BITS_PATTERN, dtype=np.float32) * 2.0 - 1.0
# Half-bit offsets of the six high preamble chips used for the channel
# estimate (tag_decoder_impl.cc:103): chips {0,1,3,6,10,11}.
_H_CHIPS = np.array([0, 1, 3, 6, 10, 11], dtype=np.int32)


@functools.lru_cache(maxsize=32)
def sync_positions(cfg: ReaderConfig):
    """(half-bit sample offsets (n_hb,), channel-chip indices, n_off) of the
    preamble search (sync.py:29-49's _sync_selection, as positions)."""
    half = cfg.n_samples_tag_bit / 2.0
    hb_pos = np.floor(np.arange(cfg.preamble_half_bits) * half).astype(np.int64)
    chips = _H_CHIPS[_H_CHIPS < cfg.preamble_half_bits].astype(np.int64)
    return hb_pos, chips, cfg.sync_search


def data_shift(cfg: ReaderConfig) -> int:
    """Samples from the correlation offset to the data index: the preamble
    and half a bit (tag_decoder_impl.cc:107)."""
    return int(cfg.tag_preamble_bits * cfg.n_samples_tag_bit + cfg.n_samples_tag_bit / 2.0)


@functools.lru_cache(maxsize=32)
def _search_device(cfg: ReaderConfig, device: torch.device):
    """The preamble search's tables on a device, kept for the next decode:
    the (n_hb, n_off) int64 sample position of each half-bit at each offset,
    the (n_hb, 1) float32 template and the channel chips' int64 rows."""
    hb_pos, chips, n_off = sync_positions(cfg)
    return (profiling.to_device(hb_pos[:, None] + np.arange(n_off), device),
            profiling.to_device(_PREAMBLE_PM[:, None], device),
            profiling.to_device(chips, device))


def preamble_search(frames: torch.Tensor, cfg: ReaderConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correlation power, channel mean), each (..., n_off), of the preamble
    at every search offset of frames (..., W) complex64."""
    pos, pm, chips = _search_device(cfg, frames.device)
    x = frames[..., pos]                                 # (..., n_hb, n_off)
    corr_re = (x.real * pm).sum(dim=-2)
    corr_im = (x.imag * pm).sum(dim=-2)
    h_all = x[..., chips, :].mean(dim=-2)
    return corr_re ** 2 + corr_im ** 2, h_all


def tag_sync(frames: torch.Tensor, cfg: ReaderConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Locate the preamble and estimate the channel for a batch of frames.

    frames: (E, W) complex64 decode windows.  Returns (data_index (E,) int32,
    h_est (E,) complex64); data_index points half a bit past the preamble
    end (tag_decoder_impl.cc:107)."""
    power, h_all = preamble_search(frames, cfg)
    max_index = torch.argmax(power, dim=1)
    h_est = h_all.gather(1, max_index[:, None])[:, 0]
    return (max_index + data_shift(cfg)).to(torch.int32), h_est
