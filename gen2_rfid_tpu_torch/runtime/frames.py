"""Decode-window extraction from gated command events.

PyTorch counterpart of ``gen2_rfid_tpu/runtime/frames.py``: all candidate
windows are gathered at once as a fixed-shape batch, DC-corrected with the
per-event estimate, with the |.|^2 side channel (``magn_squared_samples``,
gate_impl.cc:170-186) alongside.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import torch

from ..config import ReaderConfig

if TYPE_CHECKING:
    from ..dsp.gate import GateEvents

# Window starts are rounded down to multiples of this granule; the residual
# 0..GRANULE-1 start offset is absorbed by the decoder's preamble sync
# search.  The port keeps it because it decides which samples a window holds.
GRANULE = 8


def gather_aligned_windows_multi(y_c: torch.Tensor, starts: torch.Tensor,
                                 chans: torch.Tensor, width: int):
    """(len(starts), width + GRANULE) windows, window e from channel
    chans[e] of y_c (C, n) at starts[e] rounded down to the granule, as one
    gather over the (C * n_rows, GRANULE) view (frames.py:46-67).  A row past
    the channel's end clamps to its last row (masked by the fits flags
    downstream)."""
    g = GRANULE
    c, n = y_c.shape
    n_rows = -(-n // g)
    yp = torch.cat([y_c, y_c.new_zeros((c, n_rows * g - n))], dim=1).reshape(c * n_rows, g)
    w_rows = width // g + 2
    r0 = torch.clamp(starts.to(torch.int64), min=0) // g
    rows = torch.clamp(
        r0[:, None] + torch.arange(w_rows, device=y_c.device)[None, :],
        max=n_rows - 1) + chans.to(torch.int64)[:, None] * n_rows
    out = yp[rows]                                   # (E, w_rows, g)
    return out.reshape(starts.shape[0], w_rows * g)[:, : width + g]


def gather_aligned_windows(y: torch.Tensor, starts: torch.Tensor, width: int):
    """The windows of one channel y (n,): the C = 1 case of
    ``gather_aligned_windows_multi``."""
    return gather_aligned_windows_multi(y[None], starts, torch.zeros_like(starts), width)


def extract_windows(
    y: torch.Tensor, events: "GateEvents", cfg: ReaderConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """DC-corrected EPC-length windows for every event.

    Returns (frames (E, epc_window + GRANULE) complex64, magn2 float32,
    rn16_fits (E,) bool, epc_fits (E,) bool)."""
    n = y.shape[0]
    w = cfg.epc_window
    frames = gather_aligned_windows(y, events.index, w) - events.dc[:, None]
    magn2 = frames.real ** 2 + frames.imag ** 2
    rn16_fits = events.valid & (events.index + cfg.rn16_window <= n)
    epc_fits = events.valid & (events.index + w <= n)
    return frames, magn2.to(torch.float32), rn16_fits, epc_fits
