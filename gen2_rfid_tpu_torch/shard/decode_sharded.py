"""Halo sizes and the valid-mode front end of a time block.

The part of ``gen2_rfid_tpu/shard/decode_sharded.py`` that the chunked
stream decoder (runtime/stream.py) needs: how much context a block carries
on each side, and the matched filter over a block without implicit history.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ReaderConfig
from ..kernels.gate_front import front_taps, gate_front


def halo_sizes(cfg: ReaderConfig) -> Tuple[int, int]:
    """(left, right) halo in post-decimation samples (decode_sharded.py:42-56).

    Left: the longest command (Query: preamble + 22 max-length PIE bits) +
    T1 quiet + the moving-average window + margin, enough to rebuild the gate
    state at a block boundary.  Right: a trigger on the last owned sample
    still needs its whole EPC window."""
    cmd_us = (
        cfg.delim_us + 2 * cfg.pw_us + 8 * cfg.pw_us + cfg.trcal_us
        + cfg.query_length * 4 * cfg.pw_us
    )
    left = int(cmd_us * cfg.sample_rate / 1e6) + cfg.n_samples_t1 + cfg.win_length + 64
    right = cfg.epc_window + 64
    return left, right


def front_valid(x2: torch.Tensor, cfg: ReaderConfig) -> Tuple[torch.Tensor, ...]:
    """The fused front end over a block with no implicit history: (y2, amp,
    avgsum) with y[k] = sum_{j<T} x[k*decim + j] for every k whose taps lie in
    the block (decode_sharded.py:59-73's valid FIR with the boxcar taps).

    One ``gate_front`` launch (the kernel on CUDA, its plain version on the
    CPU): the block is left-padded by p = decim*ceil((T-1)/decim) - (T-1)
    zeros, so that output (T-1+p)/decim of the zero-history FIR is y[0],
    summed in the same tap order; the outputs before it are dropped, and
    zeros on the right make room for the last valid output.  amp is |y|;
    avgsum is the windowed |y| sum over the valid y alone, zero history, as
    the JAX package's gate takes it from _fir_valid's y: the kernel's first
    win-1 sums also hold the dropped outputs' |y|, so those restart at y[0]
    as a running sum of the kept amp."""
    n_taps, decim = front_taps(cfg), cfg.decim
    n = x2.shape[1]
    n_valid = max((n - n_taps) // decim + 1, 0)
    p = decim * -(-(n_taps - 1) // decim) - (n_taps - 1)
    k0 = (n_taps - 1 + p) // decim
    right = max((k0 + n_valid) * decim - (n + p), 0)
    xp = torch.cat([x2.new_zeros((2, p)), x2, x2.new_zeros((2, right))], dim=1)
    y2, amp, avgsum, _ = gate_front(xp.contiguous(), decim, n_taps, cfg.win_length,
                                    cfg.dc_length)
    cut = slice(k0, k0 + n_valid)
    amp, avgsum = amp[cut], avgsum[cut]
    head = min(cfg.win_length - 1, n_valid)
    avgsum = torch.cat([torch.cumsum(amp[:head], 0), avgsum[head:]])
    return y2[:, cut].contiguous(), amp, avgsum


def _fir_valid(x2: torch.Tensor, cfg: ReaderConfig) -> torch.Tensor:
    """(2, n_valid) y of ``front_valid``: the matched filter over a block
    without implicit history."""
    return front_valid(x2, cfg)[0]
