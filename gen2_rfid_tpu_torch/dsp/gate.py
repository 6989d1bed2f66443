"""Reader-command gate, native mode: events from the packed gate flags.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/gate.py::gate_detect`` (native
branch), the block-parallel re-design of the reference gate's per-sample FSM
(``gate_impl.cc:85-200``).  The per-sample flags (rise, qualify, marker,
quiet_after) come packed from the gate-stack kernel
(kernels/gate_stack.py); from them this module counts the PIE pulses since
the last reset, solves the trigger, compacts the triggers to a fixed
``max_events`` table and measures DC and CW noise at each event.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ReaderConfig
from ..kernels.gate_stack import MARKER, QUALIFY, QUIET, RISE, gate_stack_for_cfg
from ..runtime.frames import gather_aligned_windows


class GateEvents(NamedTuple):
    """Fixed-capacity command-event table."""

    index: torch.Tensor      # (max_events,) int32 sample index of window start
    dc: torch.Tensor         # (max_events,) complex64 DC estimate at the event
    valid: torch.Tensor      # (max_events,) bool
    n_events: torch.Tensor   # () int32
    noise_var: torch.Tensor  # (max_events,) float32 CW noise power at the event
    n_pulses: torch.Tensor   # (max_events,) int32 PIE pulses of the command


def _event_window_stats(y: torch.Tensor, ev_c: torch.Tensor, w: int):
    """(dc mean, noise variance) over the w samples ending at each event, in
    the centered per-event form (gate.py:53-85): granule-aligned rows are
    gathered and the exact w-window is selected with a mask."""
    start = torch.clamp(ev_c - (w - 1), min=0)
    win = gather_aligned_windows(y, start, w)          # (cap, w + g)
    g = win.shape[1] - w
    off = start - (start // g) * g                      # in-row start offset
    col = torch.arange(w + g, dtype=torch.int32, device=y.device)[None, :]
    mask = (col >= off[:, None]) & (col < (off + w)[:, None])
    mw = mask.to(torch.float32)
    dc = (win * mw).sum(dim=1) / w
    cen = (win - dc[:, None]) * mw
    nv = torch.clamp((cen.real ** 2 + cen.imag ** 2).sum(dim=1) / w, min=1e-12)
    return dc, nv


def _rises_since_reset(rise: torch.Tensor, reset: torch.Tensor,
                       max_span: int) -> torch.Tensor:
    """out[i] = #{j : p*(i) < j <= i, rise[j]}, p*(i) the last reset <= i
    (gate.py:108-137): the same segmented doubling scan, in exact int32."""
    s = torch.where(reset, 0, rise.to(torch.int32))
    r = reset

    def shifted(a, k):
        if k >= a.shape[0]:
            return torch.zeros_like(a)
        return torch.cat([a.new_zeros(k), a[:-k]])

    k = 1
    while k < max_span:
        s = s + torch.where(r, 0, shifted(s, k))
        r = r | shifted(r, k)
        k *= 2
    return s


def command_span(cfg: ReaderConfig) -> int:
    """Longest command (Query + T1) in samples, rounded up to 128: the pulse
    count's lookback (gate.py:267-271)."""
    cmd_us = (cfg.delim_us + 2 * cfg.pw_us + 8 * cfg.pw_us + cfg.trcal_us
              + cfg.query_length * 4 * cfg.pw_us + cfg.t1_us)
    return -(-int(cmd_us * cfg.sample_rate / 1e6 + 128) // 128) * 128


def gate_detect(y: torch.Tensor, cfg: ReaderConfig,
                flags: torch.Tensor = None) -> GateEvents:
    """Detect reader-command-over events in a post-decimation I/Q block.

    y: (N,) complex64.  ``flags``: the packed gate-stack flags of y; computed
    here from y when not given (the kernel on CUDA, its plain version on the
    CPU).  Native mode only."""
    n = y.shape[0]
    dev = y.device
    i32 = torch.int32
    if flags is None:
        flags = gate_stack_for_cfg(torch.stack([y.real, y.imag]).contiguous(), cfg)
    arange = torch.arange(n, dtype=i32, device=dev)
    rise = (flags & RISE) != 0
    qualify = (flags & QUALIFY) != 0
    marker = (flags & MARKER) != 0
    quiet_after = (flags & QUIET) != 0
    nt1 = cfg.n_samples_t1

    # Pulses reset at every disqualified (short) rise and at every CW marker,
    # which bounds the count's lookback to one command span.
    reset = (rise & ~qualify) | marker
    pulses_at = _rises_since_reset(rise, reset, command_span(cfg))
    trig = (rise & (pulses_at > cfg.num_pulses_command) & quiet_after
            & (arange + nt1 + 1 < n))
    trig_sample = torch.where(trig, arange + nt1 + 1, n)

    # Block-first compaction to max_events (gate.py:282-305): the T1-quiet
    # condition leaves at most one trigger per block of <= nt1+1 samples.
    cap = cfg.max_events
    bsz = 1 << max(min(nt1 + 1, 512).bit_length() - 1, 0)
    if bsz >= 8:
        nb = -(-n // bsz)
        s2 = torch.cat([trig_sample, trig_sample.new_full((nb * bsz - n,), n)])
        cand = s2.reshape(nb, bsz).amin(dim=1)
    else:
        cand = trig_sample
    has = cand < n
    pos = torch.cumsum(has.to(i32), 0, dtype=i32) - 1
    slot = torch.where(has, torch.clamp(pos, max=cap), cap)
    # Slot ``cap`` is the drop slot: triggers past capacity land there.
    ev = torch.full((cap + 1,), n, dtype=i32, device=dev)
    ev = ev.scatter(0, slot.to(torch.int64), cand)[:cap]
    valid = ev < n
    ev_c = torch.clamp(ev, max=n - 1)
    dc, nv = _event_window_stats(y, ev_c, cfg.dc_length)
    # The trigger sits nt1+1 after the command's final rise, where pulses_at
    # still holds that command's pulse count.
    rise_of_ev = torch.clamp(ev_c - (nt1 + 1), min=0)
    return GateEvents(
        index=ev,          # invalid slots keep index n (sorts last)
        dc=dc,
        valid=valid,
        n_events=trig.sum(dtype=i32),
        noise_var=nv,
        n_pulses=pulses_at[rise_of_ev.to(torch.int64)],
    )
