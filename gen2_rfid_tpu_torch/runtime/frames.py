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


def gather_aligned_windows(y: torch.Tensor, starts: torch.Tensor, width: int):
    """(len(starts), width + GRANULE) windows at starts rounded down to the
    granule; out-of-range rows clamp to the last row (masked by the fits
    flags downstream)."""
    g = GRANULE
    n = y.shape[0]
    n_rows = -(-n // g)
    yp = torch.cat([y, y.new_zeros(n_rows * g - n)]).reshape(n_rows, g)
    w_rows = width // g + 2
    r0 = torch.clamp(starts.to(torch.int64), min=0) // g
    rows = torch.clamp(
        r0[:, None] + torch.arange(w_rows, device=y.device)[None, :],
        max=n_rows - 1)
    out = yp[rows]                                   # (E, w_rows, g)
    return out.reshape(starts.shape[0], w_rows * g)[:, : width + g]


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
