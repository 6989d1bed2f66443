"""Reader-command gate: events from the per-sample edge state machine.

PyTorch counterpart of ``gen2_rfid_tpu/dsp/gate.py``, the block-parallel
re-design of the reference gate's per-sample FSM (``gate_impl.cc:85-200``).

* Native mode reads the per-sample flags (rise, qualify, marker,
  quiet_after) packed by the gate-stack kernel (kernels/gate_stack.py), or,
  for a given amplitude such as the channel-summed envelope of a diversity
  decode, by ``native_flags_from_amp``; from them it counts the PIE pulses
  since the last reset, solves the trigger and takes each block's first:
  the gate-pulses kernel (kernels/gate_pulses.py) on CUDA, its plain
  version ``gate_pulses_plain`` on the CPU.
* Compat mode keeps the reference's tie-preserving edge state (the last
  decisive sample's sign), edge runs and the two-pass reset fixed point,
  from |y| and its windowed average: three device-wide scans in the
  compat-gate kernel (kernels/compat_gate.py; ``gate_signal_state`` and
  ``_last_le`` live there under the JAX package's names).
* ``gate_detect_scan`` is the exact sequential oracle (``exact_gate=True``):
  the FSM itself, walked sample by sample by the gate-scan kernel
  (kernels/gate_scan.py).

Each compacts its triggers to a fixed ``max_events`` table and measures DC
and CW noise at each event.

``front_end`` is every capture decode's front end: it picks the build that
the mode's gate reads and forms the gate's input from it (``gate_input``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ReaderConfig
from ..kernels.compat_gate import _last_le, compat_gate_for_cfg, gate_signal_state  # noqa: F401
from ..kernels.gate_front import gate_front_for_cfg, gate_front_y_for_cfg
from ..kernels.gate_pulses import gate_pulses
from ..kernels.gate_scan import gate_scan_for_cfg
from ..kernels.gate_stack import (
    MARKER, QUALIFY, QUIET, RISE, gate_stack_for_cfg, native_flags_from_amp)
from ..runtime.frames import gather_aligned_windows_multi
from ..utils import profiling
from .filters import run_sum, window_mean


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
    gathered and the exact w-window is selected with a mask.  y (n,) gives
    (E,) each; y (C, n), C channels at the same events, gives (C, E)."""
    y_c = y if y.dim() == 2 else y[None]
    c = y_c.shape[0]
    start = torch.clamp(ev_c - (w - 1), min=0).repeat(c)
    chans = torch.arange(c, device=y.device).repeat_interleave(ev_c.shape[0])
    win = gather_aligned_windows_multi(y_c, start, chans, w)    # (C * E, w + g)
    g = win.shape[1] - w
    off = start - (start // g) * g                      # in-row start offset
    col = torch.arange(w + g, dtype=torch.int32, device=y.device)[None, :]
    mask = (col >= off[:, None]) & (col < (off + w)[:, None])
    mw = mask.to(torch.float32)
    dc = (win * mw).sum(dim=1) / w
    cen = (win - dc[:, None]) * mw
    nv = torch.clamp((cen.real ** 2 + cen.imag ** 2).sum(dim=1) / w, min=1e-12)
    if y.dim() == 2:
        return dc.reshape(c, -1), nv.reshape(c, -1)
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


def full_build(cfg: ReaderConfig, exact_gate: bool = False) -> bool:
    """Whether the gate reads |y| and its average, and so the front end's
    full build (kernels/gate_front.py): compat mode and the exact gate do;
    the native gate reads the gate-stack kernel's flags of y alone."""
    return exact_gate or cfg.mode == "compat"


def gate_input(y2: torch.Tensor, cfg: ReaderConfig, amp: torch.Tensor = None,
               avgsum: torch.Tensor = None):
    """(y, flags, amp, avg), what ``gate_detect`` reads, from a front-end
    build's outputs: the complex y of the planar y2, then with the full
    build's ``amp`` and windowed sum ``avgsum`` the average avgsum /
    win_length (flags None), and without them the gate-stack kernel's flags
    of y2 (amp and avg None)."""
    y = torch.complex(y2[0], y2[1])
    if amp is None:
        return y, gate_stack_for_cfg(y2, cfg), None, None
    return y, None, amp, window_mean(avgsum, cfg.win_length)


def front_end(x2: torch.Tensor, cfg: ReaderConfig, exact_gate: bool = False):
    """(y, flags, amp, avg) of a planar (2, N) float32 ADC-rate capture on
    its device: the full build and |y| with its average where
    ``full_build``, else the y build and the gate-stack kernel's flags of
    y.  One ``gate_front`` launch, and one ``gate_stack`` launch native."""
    if full_build(cfg, exact_gate):
        y2, amp, avgsum, _ = gate_front_for_cfg(x2, cfg)
        return gate_input(y2, cfg, amp, avgsum)
    return gate_input(gate_front_y_for_cfg(x2, cfg), cfg)


def _check_amp_avg(amp, avg, who: str) -> None:
    """Compat and the exact gate read |y| and its average from the front end
    (``front_end``: amp, and avgsum / win_length), so the decode has one
    definition of the average; they compute neither themselves."""
    if amp is None or avg is None:
        raise ValueError(f"{who} needs amp and avg, |y| and its win_length "
                         "average from the front end (dsp/gate.py::front_end)")


def _compat_triggers(amp: torch.Tensor, avg: torch.Tensor, cfg: ReaderConfig):
    """(trig, pulses_at) of the compat gate (gate.py:190-212, 238-256): the
    compat-gate kernel on CUDA, its plain version on the CPU."""
    return compat_gate_for_cfg(amp, avg, cfg)


def pulse_window(cfg: ReaderConfig) -> int:
    """The doubling scan's reach: the least power of two >= the command
    span (its steps k = 1, 2, ... < command_span(cfg))."""
    return 1 << (command_span(cfg) - 1).bit_length()


def block_size(nt1: int) -> int:
    """The block-first compaction's block (gate.py:282-305): the largest
    power of two <= min(nt1 + 1, 512), whose T1-quiet condition leaves at
    most one trigger a block; below 8 there are no blocks."""
    return 1 << max(min(nt1 + 1, 512).bit_length() - 1, 0)


def _native_triggers(flags: torch.Tensor, nt1: int, npc: int, span: int):
    """(trig, pulses_at) of the native gate from the packed flags."""
    n = flags.shape[0]
    arange = torch.arange(n, dtype=torch.int32, device=flags.device)
    rise = (flags & RISE) != 0
    qualify = (flags & QUALIFY) != 0
    marker = (flags & MARKER) != 0
    quiet_after = (flags & QUIET) != 0
    # Pulses reset at every disqualified (short) rise and at every CW marker,
    # which bounds the count's lookback to one command span.
    reset = (rise & ~qualify) | marker
    pulses_at = _rises_since_reset(rise, reset, span)
    trig = (rise & (pulses_at > npc) & quiet_after
            & (arange + nt1 + 1 < n))
    return trig, pulses_at


def _block_first(trig: torch.Tensor, nt1: int, bsz: int) -> torch.Tensor:
    """Each block's first trigger sample, t + nt1 + 1, or n where it has
    none (gate.py:282-305); one sample a block below 8."""
    n = trig.shape[0]
    arange = torch.arange(n, dtype=torch.int32, device=trig.device)
    trig_sample = torch.where(trig, arange + nt1 + 1, n)
    if bsz < 8:
        return trig_sample
    nb = -(-n // bsz)
    s2 = torch.cat([trig_sample, trig_sample.new_full((nb * bsz - n,), n)])
    return s2.reshape(nb, bsz).amin(dim=1)


def _candidates(trig: torch.Tensor, pulses_at: torch.Tensor, nt1: int, bsz: int):
    """(cand, pulses, counts) from the per-sample triggers and pulse counts:
    each block's first trigger sample and the count at its rise (0 where
    none), and (triggers, count at max(n - nt1 - 2, 0)), the count an
    invalid slot, whose event is clamped to n - 1, keeps."""
    n = trig.shape[0]
    i32 = torch.int32
    cand = _block_first(trig, nt1, bsz)
    rise = torch.clamp(cand - (nt1 + 1), min=0).to(torch.int64)
    pulses = torch.where(cand < n, pulses_at[rise].to(i32), 0)
    counts = torch.stack([trig.sum(dtype=i32), pulses_at[max(n - nt1 - 2, 0)].to(i32)])
    return cand, pulses, counts


def gate_pulses_plain(flags: torch.Tensor, nt1: int, npc: int, bsz: int, window: int):
    """Plain version of the gate-pulses kernel (kernels/gate_pulses.py):
    the doubling scan over ``window``, the trigger test and the block-first
    pad over whole arrays; the same (cand, pulses, counts)."""
    trig, pulses_at = _native_triggers(flags, nt1, npc, window)
    return _candidates(trig, pulses_at, nt1, bsz)


@profiling.spanned("gen2.gate")
def gate_detect(y: torch.Tensor, cfg: ReaderConfig, flags: torch.Tensor = None,
                amp: torch.Tensor = None, avg: torch.Tensor = None) -> GateEvents:
    """Detect reader-command-over events in a post-decimation I/Q block.

    y: (N,) complex64.  Native mode reads ``flags``, the packed gate-stack
    flags of y; without them it takes the flags of ``amp`` when given, its
    average ``avg`` or else ``run_sum(amp, win) / win`` (gate.py:170-184), and
    otherwise computes them from y (the kernel on CUDA, its plain version on
    the CPU).  Compat mode reads ``amp`` and ``avg``, |y| and its windowed
    average from the front end, which the caller passes."""
    n = y.shape[0]
    dev = y.device
    i32 = torch.int32
    nt1 = cfg.n_samples_t1
    bsz = block_size(nt1)
    if cfg.mode == "compat":
        _check_amp_avg(amp, avg, "compat gate_detect")
        trig, pulses_at = _compat_triggers(amp, avg, cfg)
        cand, cand_pulses, counts = _candidates(trig, pulses_at, nt1, bsz)
    else:
        if flags is None and amp is not None:
            if avg is None:
                avg = window_mean(run_sum(amp, cfg.win_length), cfg.win_length)
            flags = native_flags_from_amp(amp, avg, cfg.n_samples_pw // 2, nt1,
                                          cfg.thresh_fraction)
        elif flags is None:
            if avg is not None:
                raise ValueError("native gate_detect takes avg only with the amp it averages")
            flags = gate_stack_for_cfg(torch.stack([y.real, y.imag]).contiguous(), cfg)
        geo = (nt1, cfg.num_pulses_command, bsz, pulse_window(cfg))
        pulses_of = gate_pulses if flags.device.type == "cuda" else gate_pulses_plain
        cand, cand_pulses, counts = pulses_of(flags, *geo)

    # Block-first compaction to max_events (gate.py:282-305): the T1-quiet
    # condition leaves at most one trigger per block of <= nt1+1 samples.
    cap = cfg.max_events
    has = cand < n
    pos = torch.cumsum(has, 0, dtype=torch.int64)
    # Slot ``cap`` is the drop slot: triggers past capacity land there.
    slot = torch.where(has, torch.clamp(pos - 1, max=cap), cap)
    ev = torch.full((cap + 1,), n, dtype=i32, device=dev).scatter_(0, slot, cand)[:cap]
    # The trigger sits nt1+1 after the command's final rise, whose pulse
    # count each candidate carries; an invalid slot keeps the count at the
    # rise nt1+1 before n-1 (counts[1]).
    n_pulses = counts[1:].repeat(cap + 1).scatter_(0, slot, cand_pulses)[:cap]
    valid = ev < n
    ev_c = torch.clamp(ev, max=n - 1)
    dc, nv = _event_window_stats(y, ev_c, cfg.dc_length)
    return GateEvents(
        index=ev,          # invalid slots keep index n (sorts last)
        dc=dc,
        valid=valid,
        n_events=counts[0],
        noise_var=nv,
        n_pulses=n_pulses,
    )


@profiling.spanned("gen2.gate")
def gate_detect_scan(y: torch.Tensor, cfg: ReaderConfig, amp: torch.Tensor,
                     avg: torch.Tensor) -> GateEvents:
    """Exact sequential oracle (gate.py:323-381): the reference gate's
    per-sample FSM, which freezes detection while the gate is open and seeks
    RN16 and EPC windows in strict alternation.  ``amp``/``avg`` as for
    compat's ``gate_detect``; the FSM runs in the gate-scan kernel on CUDA
    and its plain version on the CPU."""
    _check_amp_avg(amp, avg, "gate_detect_scan")
    trig, pulses_out = gate_scan_for_cfg(amp, avg, cfg)
    return events_from_scan(y, trig, pulses_out, cfg)


def events_from_scan(y: torch.Tensor, trig: torch.Tensor, pulses_out: torch.Tensor,
                     cfg: ReaderConfig) -> GateEvents:
    """The event table from the FSM's per-sample outputs (gate.py:369-381).
    Invalid slots hold index n-1."""
    n = y.shape[0]
    i32 = torch.int32
    arange = torch.arange(n, dtype=i32, device=y.device)
    ev = torch.sort(torch.where(trig, arange, n)).values[: cfg.max_events]
    ev_c = torch.clamp(ev, max=n - 1)
    dc, nv = _event_window_stats(y, ev_c, cfg.dc_length)
    return GateEvents(
        index=ev_c,
        dc=dc,
        valid=ev < n,
        n_events=trig.sum(dtype=i32),
        noise_var=nv,
        n_pulses=pulses_out[ev_c.to(torch.int64)],
    )
