"""Compat mode's gate triggers: the tie-keeping edge state, the edge runs and
the two-pass pulse-reset fixed point, as three device-wide scans.

Counterpart of the compat branch of ``gen2_rfid_tpu/dsp/gate.py::gate_detect``
(:190-212, :238-256), whose ``lax.cummax`` / ``lax.cummin`` scans (:92,
:208, :245, :256) XLA lowers to parallel associative scans; no Pallas
kernel.  From |y|, its windowed average and the threshold fraction it gives,
per sample, whether the gate triggers there and the pulses counted since the
last reset (dsp/gate.py::gate_detect builds the event table from them).

On a CUDA tensor the wrapper launches ``csrc/compat_gate.cu``; on a CPU
tensor it runs ``compat_gate_plain``, the full-array scans in PyTorch.  Both
compare ``amp`` with the float32 product ``avg * frac`` and every output is an
integer or a bool, so the two are equal.

The kernel cuts the samples into tiles of ``TILE`` (a block each) and runs
three scans, each a tile pass, a scan of the tiles' aggregates in one block
and a pass that applies the carries (the header of ``csrc/compat_gate.cu``
has the rules).  ``compat_gate_tiles_plain`` is a PyTorch model of that
decomposition, tile aggregates and carries included, at any tile; the tests
and ``chip_smoke.py`` hold it to ``compat_gate_plain``.  The decode never
calls it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import keep, launches
from ..config import ReaderConfig

# Samples a block of the kernel takes: 512 threads of 8 consecutive samples.
TILE = 4096
_BIG = 2**31 - 1


def _last_le(mask: torch.Tensor, values: torch.Tensor, fill: int) -> torch.Tensor:
    """out[i] = values[j] for the largest j <= i with mask[j], else fill
    (gate.py:88-93)."""
    n = mask.shape[0]
    idx = torch.where(mask, torch.arange(n, device=mask.device), -1)
    m = torch.cummax(idx, 0).values
    return torch.where(m >= 0, values[torch.clamp(m, min=0)], fill).to(values.dtype)


def gate_signal_state(amp: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Per-sample POS(+1)/NEG(-1) edge state (gate_impl.cc:148-162): above
    the threshold drives POS, below drives NEG, equality keeps the state;
    it starts NEG (gate.py:96-105)."""
    i32 = torch.int32
    dec = (amp > thresh).to(i32) - (amp < thresh).to(i32)
    return _last_le(dec != 0, dec, -1)


def compat_gate_plain(amp: torch.Tensor, avg: torch.Tensor, frac: float, pw_half: int,
                      nt1: int, npc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(trig (n,) bool, pulses_at (n,) int32) of the compat gate (gate.py:190-212,
    238-256): tie-preserving state, the distance to the previous edge, the
    next edge after each sample, and the pulse count reset at short rises and
    at triggers, emulated by a two-pass fixed point over full-array scans."""
    n = amp.shape[0]
    dev = amp.device
    i32 = torch.int32
    arange = torch.arange(n, dtype=i32, device=dev)
    thresh = avg * torch.tensor(frac, dtype=torch.float32, device=dev)
    state = gate_signal_state(amp, thresh)
    prev_state = torch.cat([state.new_full((1,), -1), state[:-1]])
    rise = (state == 1) & (prev_state == -1)
    edge = rise | ((state == -1) & (prev_state == 1))
    # Distance since the previous edge == the reference's n_samples counter.
    prev_edge_incl = _last_le(edge, arange, -1)
    run_at = arange - torch.cat([prev_edge_incl.new_full((1,), -1), prev_edge_incl[:-1]])
    qualify = rise & (run_at > pw_half)
    # Next edge strictly after i (the T1-quiet trigger condition).
    nidx = torch.where(edge, arange, n)
    next_edge_incl = torch.flip(torch.cummin(torch.flip(nidx, (0,)), 0).values, (0,))
    next_edge_excl = torch.cat([next_edge_incl[1:], next_edge_incl.new_full((1,), n)])
    quiet_after = next_edge_excl > arange + nt1 + 1
    disq = rise & ~qualify
    rise_count = torch.cumsum(rise.to(i32), 0, dtype=i32)

    def triggers_from(pulses):
        return rise & (pulses > npc) & quiet_after & (arange + nt1 + 1 < n)

    reset0 = torch.where(disq, rise_count, 0)
    trig = triggers_from(rise_count - torch.cummax(reset0, 0).values)
    t_shift = torch.cat([reset0.new_zeros(1), torch.where(trig, rise_count, 0)[:-1]])
    reset2 = torch.maximum(reset0, t_shift)
    pulses_at = rise_count - torch.cummax(reset2, 0).values
    return triggers_from(pulses_at), pulses_at


# ---- the PyTorch model of the kernel's tiles and carries ------------------

def _excl(x: torch.Tensor, scan: str, init: int, reverse: bool = False) -> torch.Tensor:
    """Exclusive scan along the last dim ("max", "min" or "sum"), ``init``
    coming in; ``reverse`` scans from the end."""
    if reverse:
        return torch.flip(_excl(torch.flip(x, (-1,)), scan, init), (-1,))
    if scan == "sum":
        inc = init + torch.cumsum(x, -1, dtype=torch.int32)
    else:
        inc = getattr(torch, f"cum{scan}")(x, -1).values
        inc = inc.clamp(min=init) if scan == "max" else inc.clamp(max=init)
    first = torch.full(x.shape[:-1] + (1,), init, dtype=x.dtype)
    return torch.cat([first, inc[..., :-1]], -1).to(x.dtype)


def _last_nonzero(d: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """The last nonzero entry along the last dim at or (exclusive) before
    each position, else 0."""
    col = torch.arange(d.shape[-1]).expand_as(d)
    idx = torch.where(d != 0, col, -1)
    at = torch.cummax(idx, -1).values if inclusive else _excl(idx, "max", -1)
    return torch.where(at >= 0, torch.gather(d, -1, at.clamp(min=0)), 0)


def _tile_aggregates(d: torch.Tensor, gi: torch.Tensor, pw_half: int) -> dict:
    """The aggregate pass: per tile, whatever state comes in.  An internal edge
    is a decisive sample whose sign differs from the tile's decisive sample
    before it; the tile's first decisive sample f is an edge only if its sign
    differs from the state that comes in.  ``a`` is the internal rise count at
    the tile's last short rise among the internal rises that have an internal
    edge before them (the others' runs start outside the tile or at f)."""
    nz = d != 0
    has = nz.any(-1)
    f_pos = torch.where(nz, gi, _BIG).amin(-1)
    f_sign = torch.where(has, torch.gather(d, -1, (f_pos % d.shape[-1])[:, None])[:, 0], 0)
    p = _last_nonzero(d, inclusive=False)
    ie = nz & (p != 0) & (d != p)
    ir = ie & (d == 1)
    lie = _excl(torch.where(ie, gi, -1), "max", -1)
    c_int = torch.cumsum(ir.to(torch.int32), -1, dtype=torch.int32)
    short = ir & (lie >= 0) & (gi - lie <= pw_half)
    e1 = torch.where(ie, gi, _BIG).amin(-1)
    return {"f_pos": torch.where(has, f_pos, -1), "f_sign": f_sign,
            "last_sign": _last_nonzero(d, inclusive=True)[:, -1],
            "n_int": ir.sum(-1, dtype=torch.int32),
            "e1": torch.where(e1 < _BIG, e1, -1),
            "last_int": torch.where(ie, gi, -1).amax(-1),
            "a": torch.where(short, c_int, 0).amax(-1)}


def _tile_carries(g: dict, n: int, pw_half: int) -> dict:
    """The one-block carry pass over the tiles' aggregates: the state, the
    rise count, the last edge and the largest reset0 coming into each tile,
    and the first edge after it (a reverse scan)."""
    i32 = torch.int32
    s_in = _last_nonzero(g["last_sign"][None], inclusive=False)[0]
    s_in = torch.where(s_in != 0, s_in, -1)
    f_sign, f_pos, e1, a = g["f_sign"], g["f_pos"], g["e1"], g["a"]
    f_edge = (f_sign != 0) & (f_sign != s_in)
    f_rise = f_edge & (f_sign == 1)
    n_rises = g["n_int"] + f_rise.to(i32)
    last_edge = torch.where(g["last_int"] >= 0, g["last_int"], torch.where(f_edge, f_pos, -1))
    first_edge = torch.where(f_edge, f_pos, e1)
    count_in = _excl(n_rises[None], "sum", 0)[0]
    l_in = _excl(last_edge[None], "max", -1)[0]
    # The one rise of a tile whose previous edge may lie outside the tile
    # (count 1 among the tile's rises, or 2 after a rising f): f itself when
    # it rises, else the first internal edge when f falls.
    f_short = f_rise & ~(f_pos - l_in > pw_half)
    e1_prev = torch.where(s_in == -1, l_in, f_pos)
    e1_short = (f_sign == -1) & (e1 >= 0) & ~(e1 - e1_prev > pw_half)
    local = torch.where(f_rise, torch.where(a > 0, a + 1, f_short.to(i32)),
                        torch.where(a > 0, a, e1_short.to(i32)))
    m0 = torch.where(local > 0, count_in + local, 0)
    return {"s_in": s_in, "count_in": count_in, "l_in": l_in,
            "m0_in": _excl(m0[None], "max", 0)[0],
            "next_after": _excl(torch.where(first_edge >= 0, first_edge, _BIG)[None], "min", n,
                                reverse=True)[0]}


def compat_gate_tiles_plain(amp: torch.Tensor, avg: torch.Tensor, frac: float,
                            pw_half: int, nt1: int, npc: int, tile: int = TILE
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch model of the kernel: the samples cut into tiles of ``tile``
    (the last padded with ties), the aggregate pass, the carry pass, the
    apply pass (state, edges, short rises, rise count, reset0's running
    maximum, the next edge, trig0), the scan of each tile's last trig0 and
    the finishing pass (reset2's running maximum, trig, pulses_at).  Same
    outputs as ``compat_gate_plain``."""
    i32 = torch.int32
    amp = amp.detach().cpu().to(torch.float32)
    avg = avg.detach().cpu().to(torch.float32)
    n = amp.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool), torch.zeros(0, dtype=i32)
    thresh = avg * torch.tensor(frac, dtype=torch.float32)
    dec = (amp > thresh).to(i32) - (amp < thresh).to(i32)
    nt = -(-n // tile)
    d = torch.cat([dec, dec.new_zeros(nt * tile - n)]).reshape(nt, tile)
    gi = torch.arange(nt * tile, dtype=i32).reshape(nt, tile)
    car = _tile_carries(_tile_aggregates(d, gi, pw_half), n, pw_half)
    c = {k: v[:, None] for k, v in car.items()}       # a tile's carries, one row

    # Apply: the state (the last decisive sign, else the carried one), the
    # edges, each rise's run from the previous edge, the rise count, reset0's
    # running maximum, the next edge after each sample and trig0.
    st = _last_nonzero(d, inclusive=True)
    st = torch.where(st != 0, st, c["s_in"])
    prev = torch.cat([c["s_in"], st[:, :-1]], -1)
    rise = (st == 1) & (prev == -1)
    edge = rise | ((st == -1) & (prev == 1))
    prev_edge = torch.maximum(c["l_in"], _excl(torch.where(edge, gi, -1), "max", -1))
    disq = rise & ~(gi - prev_edge > pw_half)
    rc = c["count_in"] + torch.cumsum(rise.to(i32), -1, dtype=i32)
    reset0 = torch.where(disq, rc, 0)
    m0 = torch.maximum(c["m0_in"], torch.cummax(reset0, -1).values)
    nxt = torch.minimum(c["next_after"],
                        _excl(torch.where(edge, gi, _BIG), "min", _BIG, reverse=True))
    gl = gi.to(torch.int64)
    cand = rise & (nxt > gl + nt1 + 1) & (gl + nt1 + 1 < n)
    trig0 = cand & (rc - m0 > npc)
    last_trig0 = torch.where(trig0, rc, 0).amax(-1)

    # Finish: reset2 = max(reset0, the previous sample's trig0 count); its
    # running maximum starts from reset0's carried one and the last trig0
    # count of every tile before (the shift into this tile's first sample
    # included).
    t_in = _excl(last_trig0[None], "max", 0)[0]
    shifted = torch.cat([torch.zeros(nt, 1, dtype=i32), torch.where(trig0, rc, 0)[:, :-1]], -1)
    m2 = torch.maximum(torch.maximum(car["m0_in"], t_in)[:, None],
                       torch.cummax(torch.maximum(reset0, shifted), -1).values)
    trig = cand & (rc - m2 > npc)
    return trig.reshape(-1)[:n], (rc - m2).reshape(-1)[:n].to(i32)


# ---- inputs the kernel and its model are held to --------------------------

def compat_cases(tile: int = TILE):
    """(label, amp, avg, (frac, pw_half, nt1, npc)) on the CPU: the inputs the
    kernel and its model are held to at tiles of ``tile``.  Against a
    threshold of 0.5 (avg 1, frac 0.5; amp 0.5 is a tie): ties from the
    first sample across one to three tiles; a tie run across a tile edge;
    falls and rises on a tile's first and last sample, so trig0 lands on
    them; a trigger whose reset of the count (shifted by a sample) crosses a
    tile edge and decides a later pulse's trigger; triggers just inside and
    just outside the tail (a rise at n - nt1 - 2 and n - nt1 - 1); lengths
    under one tile and one past a multiple of it; random runs of above,
    below and tied samples with small widths, so that short rises and
    triggers come often."""
    frac, pw_half, nt1, npc = 0.5, 2, 5, 3
    args = (frac, pw_half, nt1, npc)
    low, high = pw_half + 2, pw_half + 1
    # A command: npc+1 low pulses (each a long run, so each qualifies) on a
    # high carrier; its last rise triggers if quiet for nt1+1 samples after.
    pattern = torch.tensor(([0.0] * low + [1.0] * high) * (npc + 1))
    span = pattern.shape[0] - high               # first fall .. last rise

    def command(n, rise, lead=1.0):
        amp = torch.full((n,), lead)
        amp[rise - span: rise] = pattern[:span]
        return amp

    cases = []

    def add(label, amp, a=args):
        cases.append((label, amp, torch.ones(amp.shape[0]), a))

    t = tile
    for k in (1, 2, 3):
        add(f"ties from sample 0 across {k} tiles, then a command",
            torch.cat([torch.full((k * t + 7,), 0.5), command(3 * t, t // 2 + 40)]))
    add("ties only", torch.full((2 * t + 3,), 0.5))
    add("below from sample 0, a tie run across a tile edge", torch.cat([
        torch.zeros(t - 3), torch.full((9,), 0.5), torch.ones(t), torch.zeros(5),
        command(t + 60, t // 2 + 40)]))
    for rise in (t - 1, t, t + 1, 2 * t - 1, 2 * t):
        if rise >= span:
            add(f"a command's last rise (trig0) on sample {rise}", command(3 * t + 11, rise))
    for fall in (t - 1, t, 2 * t - 1):
        add(f"a command's first fall on sample {fall}", command(3 * t + 11, fall + span))
    # A command triggering at r, then one more pulse: the first pass counts
    # npc+2 pulses there and triggers; the second resets at r+1 and does not.
    # The extra pulse's low run is long (it qualifies) or short (it resets).
    for r in (t - 2, t - 1, t):
        if r >= span:
            for run, kind in ((low, "long"), (1, "short")):
                amp = command(3 * t, r)
                amp[r + nt1 + 10: r + nt1 + 10 + run] = 0.0
                add(f"a trigger at {r}, then a {kind} pulse", amp)
    for n in (span + nt1 + 3, t - 1, t + 1, 2 * t + 1):
        if n - nt1 - 2 >= span:
            for rise in (n - nt1 - 2, n - nt1 - 1):
                add(f"n={n}, a last rise at {rise}", command(n, rise))
        add(f"decisions drawn at random, n={n}", torch.from_numpy(
            np.random.default_rng(n).choice([0.0, 0.5, 1.0], n).astype(np.float32)))
    add("one sample", torch.ones(1))
    rng = np.random.default_rng(7)
    for seed in range(6):
        n = int(rng.integers(2 * t, 6 * t)) + 2000
        levels = rng.choice([1.0, 0.0, 0.5], p=[0.45, 0.35, 0.2], size=n)
        amp = np.repeat(levels, rng.integers(1, 12, size=n))[:n].astype(np.float32)
        add(f"random runs seed={seed}", torch.from_numpy(amp),
            (0.5, int(rng.integers(0, 4)), int(rng.integers(0, 6)), int(rng.integers(0, 3))))
    return cases


# ---- the kernel -------------------------------------------------------------

def _lib():
    from ._build import library

    lib = library("compat_gate")
    lib.compat_gate_launch.restype = ctypes.c_int
    lib.compat_gate_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.compat_gate_scratch_words.restype = ctypes.c_longlong
    lib.compat_gate_scratch_words.argtypes = [ctypes.c_longlong]
    lib.compat_gate_tile.restype = ctypes.c_int
    lib.compat_gate_tile.argtypes = []
    return lib


def compat_gate(amp: torch.Tensor, avg: torch.Tensor, frac: float, pw_half: int,
                nt1: int, npc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) float32 |y| and windowed average -> (trig (n,) bool,
    pulses_at (n,) int32)."""
    if amp.dim() != 1 or avg.shape != amp.shape:
        raise ValueError(f"compat_gate takes two (n,) tensors, got "
                         f"{tuple(amp.shape)} and {tuple(avg.shape)}")
    if amp.device.type == "cpu" and avg.device.type == "cpu":
        return compat_gate_plain(amp.to(torch.float32), avg.to(torch.float32), frac,
                                 pw_half, nt1, npc)
    if amp.device.type != "cuda" or avg.device != amp.device:
        raise ValueError(f"compat_gate runs on cuda or cpu, not {amp.device} / {avg.device}")
    if amp.dtype != torch.float32 or avg.dtype != torch.float32:
        raise ValueError("compat_gate takes float32 tensors")
    if pw_half < 0 or nt1 < 0:
        raise ValueError(f"compat_gate needs pw_half >= 0 and nt1 >= 0, got {pw_half}, {nt1}")
    amp, avg = amp.contiguous(), avg.contiguous()
    n = amp.shape[0]
    if n + nt1 + TILE + 2 >= 2**31 - 1:
        raise ValueError(f"compat_gate indexes samples in int32; n={n} is too long")
    trig = torch.empty((n,), dtype=torch.bool, device=amp.device)
    pulses_at = torch.empty((n,), dtype=torch.int32, device=amp.device)
    if n == 0:
        return trig, pulses_at
    lib = _lib()
    scratch = torch.empty((lib.compat_gate_scratch_words(n),), dtype=torch.int32,
                          device=amp.device)
    with torch.cuda.device(amp.device):
        stream = torch.cuda.current_stream(amp.device).cuda_stream
        err = lib.compat_gate_launch(amp.data_ptr(), avg.data_ptr(), n, frac, pw_half, nt1,
                                     npc, trig.data_ptr(), pulses_at.data_ptr(),
                                     scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"compat_gate kernel launch failed: CUDA error {err}")
    launches["compat_gate"] += 1
    keep("compat_gate", (amp, avg), (frac, pw_half, nt1, npc))
    return trig, pulses_at


def compat_gate_for_cfg(amp: torch.Tensor, avg: torch.Tensor, cfg: ReaderConfig):
    return compat_gate(amp, avg, cfg.thresh_fraction, cfg.n_samples_pw // 2,
                       cfg.n_samples_t1, cfg.num_pulses_command)
