"""Compat mode's gate triggers: the tie-keeping edge state, the edge runs and
the two-pass pulse-reset fixed point, in one kernel launch.

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

The kernel is one single-pass scan with decoupled look-back: each tile (a
block) turns its samples into a 20-word descriptor of what it does to the
carry coming in, scans its words' descriptors once, looks back over its
predecessors' published descriptors and carries, and writes its outputs
(the header of ``csrc/compat_gate.cu`` has the design).
``compat_gate_tiles_plain`` is a PyTorch model of that decomposition at any
tile: the descriptors (``span_descriptors``), their combine
(``desc_compose``, ``desc_apply``), the halo and the look-back
(``look_back_carries``); the tests and ``chip_smoke.py`` hold it to
``compat_gate_plain``.  The decode never calls it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import keep
from ..config import ReaderConfig
from ._build import F32, I32, I64, PTR, Library, launch

# The kernel's configurations, (threads a block, words of 32 samples a
# thread), as csrc/compat_gate.cu's kConfigs; a tile is 32 * threads * words.
CONFIGS = ((64, 1), (128, 1), (256, 1), (256, 2))


def config_tile(config: int) -> int:
    threads, words = CONFIGS[config]
    return 32 * threads * words


# Fewest tiles a launch of 4,096- or 8,192-sample tiles is given (below,
# the next smaller tile).
MIN_TILES = 96


def choose_config(n: int, nt1: int) -> int:
    """The configuration the wrapper launches for n samples, from the sweep
    ``chip_smoke.py`` records (NVIDIA H100, read flush): one tile of 128
    threads up to 4,096 samples (a live window); 16,384-sample tiles of 256
    threads x 2 words once the T1 window reaches 1,024 samples (fastest at
    8 and 16 Msps, nt1 1,920 and 3,840; not at 4 Msps, nt1 960, where the
    length rule's 256x1 was; the cut lies between); else the largest tile
    of one word a thread that gives at least MIN_TILES tiles: 256x1 (8,192
    samples), 128x1 (4,096), or 64x1 (2,048).  Measured: 128x1 fastest at
    2^19 samples (128 of its tiles, 64 of 256x1's), 256x1 from 2^20 (128
    of its tiles) to the bench length, 64x1 at golden (106 of its tiles, 53
    of 128x1's); MIN_TILES lies between the 64 and 128 tiles measured."""
    if n <= config_tile(1):
        return 1
    if nt1 >= 1024:
        return 3
    for config in (2, 1):
        if n >= MIN_TILES * config_tile(config):
            return config
    return 0


# The tile of configuration 1 (128 threads x 1 word), which takes captures of
# one tile; the default of the model and of compat_cases.
TILE = config_tile(1)


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


# ---- the PyTorch model of the kernel's descriptors and look-back ----------
#
# A span of samples (a word of 32, a thread's words, a tile, a run of tiles)
# acts on the carry C = (s, cnt, l, m0, t) coming into it: the state before
# it (-1 or +1), the rises before it, the last edge before it (-1: none),
# reset0's running maximum (the rise count at the last short rise, 0: none)
# and the rise count at the last trig0 at or before its start - 1 (0: none).
# reset2's running maximum at a sample is max(m0, t) brought up to it.  The
# span's descriptor gives, for each incoming state b (its branch), what
# leaves: the state, the rises it adds and its last edge; the test of its
# first rise whose previous edge lies before the span (short iff l >= LT);
# and for each outcome u of that test, the index among the span's rises of
# its last short rise (MS) and of its last trig0 (TK), which fires iff the
# pulses coming in, P = cnt - m0, reach TT (0 once a short rise in the span
# fixed it).  Pulse counts grow with each rise while no short rise resets
# them, so a span's last candidate before its first short rise fires past
# one value of P and every earlier one fires only if it does: the last trig0
# is one threshold, and the descriptor stays 20 words under composition.

SO, NR, LE, LT, MS, TK, TT = 0, 1, 2, 3, 4, 5, 6   # MS, TK, TT: + 3u
BRANCH = 10                                         # words a branch
DESC_WORDS = 2 * BRANCH
NONE = 2**31 - 1                                    # no test / no below
WORD = 32                                           # samples a word
ONE_TILE_WORD = 16                                  # a word of a one-tile launch


def _branch(d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The branch-b half of descriptors d (..., 20); b (...) in {0, 1}."""
    return torch.where((b == 1)[..., None], d[..., BRANCH:], d[..., :BRANCH])


def desc_identity(shape=()) -> torch.Tensor:
    d = torch.zeros(tuple(shape) + (DESC_WORDS,), dtype=torch.int64)
    d[..., BRANCH + SO] = 1
    d[..., LE] = d[..., BRANCH + LE] = -1
    d[..., LT] = d[..., BRANCH + LT] = NONE
    return d


def desc_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The descriptor of span a followed by span b (both (..., 20))."""
    halves = []
    for br in (0, 1):
        A = a[..., br * BRANCH:(br + 1) * BRANCH]
        B = _branch(b, A[..., SO])                  # b's branch: a's outgoing state
        test_a = A[..., LT] != NONE
        noedge_a = A[..., LE] < 0                   # then b's state is br too
        # b's test resolves against a's last edge when a has one.
        ub_fix = (B[..., LT] != NONE) & (A[..., LE] >= B[..., LT])
        nr_a = A[..., NR]
        half = [B[..., SO], nr_a + B[..., NR],
                torch.where(B[..., LE] >= 0, B[..., LE], A[..., LE]),
                torch.where(test_a, A[..., LT], torch.where(noedge_a, B[..., LT], NONE))]
        for u in (0, 1):
            ua = test_a & bool(u)
            ub = torch.where(test_a, ub_fix, torch.where(noedge_a, torch.full_like(ub_fix, bool(u)),
                                                         ub_fix))
            ms_a, tk_a, tt_a = (torch.where(ua, A[..., f + 3], A[..., f]) for f in (MS, TK, TT))
            ms_b, tk_b, tt_b = (torch.where(ub, B[..., f + 3], B[..., f]) for f in (MS, TK, TT))
            # b's pulses coming in: fixed by a's last short rise, else P + a's rises.
            fire = nr_a - ms_a >= tt_b
            from_b = (tk_b > 0) & ((ms_a == 0) | fire)
            half += [torch.where(ms_b > 0, nr_a + ms_b, ms_a),
                     torch.where(from_b, nr_a + tk_b, tk_a),
                     torch.where(from_b, torch.where(ms_a > 0, 0, (tt_b - nr_a).clamp(min=0)),
                                 tt_a)]
        halves += half
    return torch.stack(halves, -1)


def desc_apply(d: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The carry (..., 5) leaving a span of descriptor d that c enters."""
    s, cnt, l, m0, t = c.unbind(-1)
    D = _branch(d, (s == 1).to(torch.int64))
    u = l >= D[..., LT]
    ms, tk, tt = (torch.where(u, D[..., f + 3], D[..., f]) for f in (MS, TK, TT))
    return torch.stack([torch.where(D[..., SO] == 1, 1, -1), cnt + D[..., NR],
                        torch.where(D[..., LE] >= 0, D[..., LE], l),
                        torch.where(ms > 0, cnt + ms, m0),
                        torch.where((tk > 0) & (cnt - m0 >= tt), cnt + tk, t)], -1)


CARRY0 = (-1, 0, -1, 0, 0)          # the capture's start


def desc_scan(d: torch.Tensor, dim: int, exclusive: bool = False) -> torch.Tensor:
    """Inclusive (or exclusive) composition of descriptors along ``dim``
    (doubling steps, as the kernel's warp scans)."""
    d = d.movedim(dim, -2)
    n = d.shape[-2]
    step = 1
    while step < n:
        ident = desc_identity(d.shape[:-2] + (step,))
        d = desc_compose(torch.cat([ident, d[..., :-step, :]], -2), d)
        step *= 2
    if exclusive:
        d = torch.cat([desc_identity(d.shape[:-2] + (1,)), d[..., :-1, :]], -2)
    return d.movedim(-2, dim)


def span_descriptors(dec: torch.Tensor, gi: torch.Tensor, cand: torch.Tensor, pw_half: int,
                     npc: int) -> torch.Tensor:
    """Descriptors (..., 20) of spans along the last dim: decisions dec
    (+1 above, -1 below, 0 tie), global indices gi, and cand, whether a rise
    there would be a trigger candidate (T1-quiet after it and inside the
    tail; it needs no state)."""
    halves = []
    for s_in in (-1, 1):
        st = _last_nonzero(dec, inclusive=True)
        st = torch.where(st != 0, st, s_in)
        prev = torch.cat([torch.full_like(st[..., :1], s_in), st[..., :-1]], -1)
        rise = (st == 1) & (prev == -1)
        edge = st != prev
        pe = _excl(torch.where(edge, gi, -1), "max", -1)
        tested = rise & (pe < 0)                    # the first rise, with no edge before
        k = torch.cumsum(rise.to(torch.int64), -1)
        half = [(st[..., -1] == 1).to(torch.int64), k[..., -1],
                torch.where(edge, gi, -1).amax(-1),
                torch.where(tested.any(-1), torch.where(tested, gi - pw_half, NONE).amin(-1),
                            NONE)]
        c = rise & cand
        for u in (0, 1):
            short = rise & torch.where(pe >= 0, gi - pe <= pw_half, bool(u))
            msrun = torch.cummax(torch.where(short, k, 0), -1).values
            k_det = torch.where(c & (msrun > 0) & (k - msrun > npc), k, 0).amax(-1)
            k_pre = torch.where(c & (msrun == 0), k, 0).amax(-1)
            half += [msrun[..., -1], torch.where(k_det > 0, k_det, k_pre),
                     torch.where(k_det > 0, 0, torch.where(k_pre > 0, (npc + 1 - k_pre).clamp(min=0),
                                                           0))]
        halves += half
    return torch.stack(halves, -1).to(torch.int64)


def _excl(x: torch.Tensor, scan: str, init: int, reverse: bool = False) -> torch.Tensor:
    """Exclusive scan along the last dim ("max" or "min"), ``init`` coming
    in; ``reverse`` scans from the end."""
    if reverse:
        return torch.flip(_excl(torch.flip(x, (-1,)), scan, init), (-1,))
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


def look_back_carries(tile_desc: torch.Tensor, lag: torch.Tensor) -> torch.Tensor:
    """The carry into each tile (nt, 5) as its look-back finds it: tile t
    composes the aggregates of the ``lag[t]`` tiles before it (at most 3)
    and applies them to the inclusive carry of the tile before those (the
    capture's start for none), which that tile published."""
    nt = tile_desc.shape[0]
    t_idx = torch.arange(nt)
    lag = torch.minimum(lag, t_idx)
    c0 = torch.tensor(CARRY0, dtype=torch.int64)
    incl = desc_apply(desc_scan(tile_desc, 0), c0.expand(nt, 5))   # published inclusives
    acc = desc_identity((nt,))
    for j in (1, 2, 3):
        take = (lag >= j)[:, None]
        acc = torch.where(take, desc_compose(tile_desc[(t_idx - j).clamp(min=0)], acc), acc)
    q = t_idx - 1 - lag
    start = torch.where((q >= 0)[:, None], incl[q.clamp(min=0)], c0)
    return desc_apply(acc, start)


def word_walk(d: torch.Tensor, gi: torch.Tensor, cand: torch.Tensor, c: torch.Tensor,
              pw_half: int, npc: int) -> dict:
    """Words (..., word) of decisions from the carries c (..., 5) entering
    them: each sample's rise count rc and reset2's running maximum m2, trig,
    and the carry leaving each word ("out")."""
    s, cnt, l, m0, t = (x[..., None] for x in c.unbind(-1))
    st = _last_nonzero(d, inclusive=True)
    st = torch.where(st != 0, st, s)
    prev = torch.cat([s, st[..., :-1]], -1)
    rise = (st == 1) & (prev == -1)
    edge = st != prev
    pe = torch.maximum(l, _excl(torch.where(edge, gi, -1), "max", -1))
    short = rise & (gi - pe <= pw_half)
    rc = cnt + torch.cumsum(rise.to(torch.int64), -1)
    m0s = torch.maximum(m0, torch.cummax(torch.where(short, rc, 0), -1).values)
    trig0 = rise & cand & (rc - m0s > npc)
    t0 = torch.maximum(t, torch.cummax(torch.where(trig0, rc, 0), -1).values)
    m2 = torch.maximum(m0s, torch.maximum(t, _excl(torch.where(trig0, rc, 0), "max", 0)))
    out = torch.stack([st[..., -1], rc[..., -1],
                       torch.maximum(l[..., 0], torch.where(edge, gi, -1).amax(-1)),
                       m0s[..., -1], t0[..., -1]], -1)
    return {"rc": rc, "m2": m2, "trig": rise & cand & (rc - m2 > npc), "out": out}


def _scan_excl(x: torch.Tensor, compose, ident: torch.Tensor) -> torch.Tensor:
    """Exclusive scan along dim 0 of rows composed by ``compose`` (doubling
    steps), ``ident`` first."""
    n, step = x.shape[0], 1
    while step < n:
        x = compose(torch.cat([ident.expand(step, -1), x[:-step]]), x)
        step *= 2
    return torch.cat([ident[None], x[:-1]])


def _compose_edges(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(so0, so1, nr0, nr1, le0, le1) of span a followed by span b."""
    out = []
    for br in (0, 1):
        m = a[:, br] == 1
        pick = lambda f: torch.where(m, b[:, 2 * f + 1], b[:, 2 * f])  # noqa: E731
        out.append((pick(0), a[:, 2 + br] + pick(1),
                    torch.where(pick(2) >= 0, pick(2), a[:, 4 + br])))
    (so0, nr0, le0), (so1, nr1, le1) = out
    return torch.stack([so0, so1, nr0, nr1, le0, le1], -1)


def _compose_pulses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(nr, ms, tk, tt) of span a followed by span b (desc_compose's pulse
    part with its test resolved)."""
    nr_a, ms_a, tk_a, tt_a = a.unbind(-1)
    nr_b, ms_b, tk_b, tt_b = b.unbind(-1)
    from_b = (tk_b > 0) & ((ms_a == 0) | (nr_a - ms_a >= tt_b))
    return torch.stack([nr_a + nr_b, torch.where(ms_b > 0, nr_a + ms_b, ms_a),
                        torch.where(from_b, nr_a + tk_b, tk_a),
                        torch.where(from_b, torch.where(ms_a > 0, 0, (tt_b - nr_a).clamp(min=0)),
                                    tt_a)], -1)


def one_tile_carries(d: torch.Tensor, gi: torch.Tensor, cand: torch.Tensor, pw_half: int,
                     npc: int) -> torch.Tensor:
    """The carry into each word (wpt, 5) of a capture of one tile, as the
    kernel finds it there, in two scans across the words: the state, the
    rises and the last edge for both incoming states; then, under the state
    and last edge now known, the rises, the last short rise and the last
    trig0 with its threshold on the pulses coming in."""
    words = span_descriptors(d, gi, cand, pw_half, npc)
    edges = words[:, [SO, BRANCH + SO, NR, BRANCH + NR, LE, BRANCH + LE]]
    e = _scan_excl(edges, _compose_edges, torch.tensor([0, 1, 0, 0, -1, -1]))
    s, cnt, l = torch.where(e[:, 0] == 1, 1, -1), e[:, 2], e[:, 4]
    D = _branch(words, (s == 1).to(torch.int64))
    u = l >= D[:, LT]
    own = torch.stack([D[:, NR]] + [torch.where(u, D[:, f + 3], D[:, f]) for f in (MS, TK, TT)],
                      -1)
    ms, tk, tt = _scan_excl(own, _compose_pulses, torch.zeros(4, dtype=torch.int64))[:, 1:].T
    return torch.stack([s, cnt, l, ms, torch.where((tk > 0) & (tt == 0), tk, 0)], -1)


def compat_gate_tiles_plain(amp: torch.Tensor, avg: torch.Tensor, frac: float,
                            pw_half: int, nt1: int, npc: int, tile: int = TILE
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch model of the kernel at tiles of ``tile`` samples, cut into
    words of 32 (16 for a capture of one tile; a tile's last word padded
    with ties): the decisions; the
    first below sample in each tile's halo (up to nt1 + 1 samples past its
    end) and, from it and the tile's words, whether a rise at each sample
    would be a trigger candidate; each word's descriptor; their scan across
    the tile (its descriptor, each word's prefix); each tile's carry from a
    look-back of 0-3 aggregates (t mod 4) onto a published inclusive carry;
    each word's carry (for a capture of one tile, ``one_tile_carries``);
    and the samples' outputs from it (``word_walk``).  Same outputs as
    ``compat_gate_plain``."""
    i64 = torch.int64
    amp = amp.detach().cpu().to(torch.float32)
    avg = avg.detach().cpu().to(torch.float32)
    n = amp.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool), torch.zeros(0, dtype=torch.int32)
    thresh = avg * torch.tensor(frac, dtype=torch.float32)
    dec = ((amp > thresh).to(i64) - (amp < thresh).to(i64))
    nt = -(-n // tile)
    word = ONE_TILE_WORD if nt == 1 else WORD
    wpt = -(-tile // word)

    def tiled(x, fill):
        x = torch.cat([x, x.new_full((nt * tile - n,), fill)]).reshape(nt, tile)
        return torch.cat([x, x.new_full((nt, wpt * word - tile), fill)], -1).reshape(nt, wpt, word)

    d = tiled(dec, 0)
    gi = tiled(torch.arange(n, dtype=i64), -1)
    real = gi >= 0

    # The halo: the first below sample in [end, end + nt1] of each tile.
    below_at = torch.where(dec == -1, torch.arange(n, dtype=i64), NONE)
    first_below_from = torch.cat([torch.flip(torch.cummin(torch.flip(below_at, (0,)), 0).values,
                                             (0,)), torch.tensor([NONE])])
    ends = torch.clamp(torch.arange(1, nt + 1, dtype=i64) * tile, max=n)
    halo = first_below_from[ends]
    halo = torch.where(halo <= ends + nt1, halo, NONE)
    # The first below after each word in its tile (or the halo), then after
    # each sample: a rise there is quiet if it lies past i + nt1 + 1.
    first_b = torch.where(d == -1, gi, NONE).amin(-1)
    after_word = torch.minimum(_excl(first_b, "min", NONE, reverse=True), halo[:, None])
    nb = torch.minimum(_excl(torch.where(d == -1, gi, NONE), "min", NONE, reverse=True),
                       after_word[..., None])
    cand = real & (d == 1) & (nb > gi + nt1 + 1) & (gi + nt1 + 1 < n)

    if nt == 1:
        c = one_tile_carries(d[0], gi[0], cand[0], pw_half, npc)[None]
    else:
        words = span_descriptors(d, gi, cand, pw_half, npc)       # (nt, wpt, 20)
        tile_desc = desc_scan(words, 1)[:, -1]
        c_tile = look_back_carries(tile_desc, torch.arange(nt) % 4)
        c = desc_apply(desc_scan(words, 1, exclusive=True), c_tile[:, None])   # (nt, wpt, 5)
    w = word_walk(d, gi, cand, c, pw_half, npc)
    trig, rc, m2 = w["trig"], w["rc"], w["m2"]
    keep_ = real.reshape(-1)
    return trig.reshape(-1)[keep_], (rc - m2).reshape(-1)[keep_].to(torch.int32)


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
    triggers come often.  And where a tile's carry comes from far: a tie
    run across 200 tiles after a fall (the rise after it counts) or a rise
    (it does not); a rise short against an edge three tiles back, and long
    against one six back (pw_half of five tiles); a trigger on a tile's last
    sample after a tile of ties, its shifted reset on the next tile's first
    sample, then one more pulse in that tile or after a tile of ties; the
    halo: a rise whose next below sample lies nt1 + 1 (not quiet) or
    nt1 + 2 (quiet) on across a tile edge, with nt1 of 5 and with nt1 past
    one and two tiles."""
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

    # The state, the last edge and the pulse count from far back.
    for first, kind in ((0.0, "a fall"), (1.0, "a rise")):
        lead = torch.cat([torch.full((9,), 1.0 - first), torch.full((4,), first)])
        add(f"a tie run across 200 tiles after {kind}, then a command", torch.cat([
            lead, torch.full((200 * t,), 0.5), command(2 * t, t)]))
    wide = (frac, 5 * t + 3, nt1, 2)
    for gap, kind in ((3, "short"), (6, "long")):
        # Rises at 0 and after the tie run (short or long against the fall at
        # 10 before it), then two pulses whose low runs are past pw_half.
        amp = torch.cat([torch.ones(10), torch.zeros(1), torch.full((gap * t,), 0.5),
                         torch.ones(20), torch.zeros(5 * t + 9), torch.ones(20),
                         torch.zeros(5 * t + 9), torch.ones(nt1 + 30)])
        add(f"a {kind} rise against an edge {gap} tiles back", amp, wide)
    for tail in ("in the next tile", "after a tile of ties"):
        amp = torch.cat([torch.ones(t), torch.full((t,), 0.5), command(t, t - 1)])
        extra = torch.full((2 * t,), 0.5)
        at = nt1 + 10 if tail == "in the next tile" else t + 3
        extra[at: at + low] = 0.0
        add(f"a trigger on a tile's last sample after a tile of ties, one more pulse {tail}",
            torch.cat([amp, extra, torch.ones(t)]))
    for wide_nt1 in (nt1, t + 7, 2 * t + 5):
        for gap in (1, 2):
            rise = 2 * t - 3
            amp = command(rise + wide_nt1 + 2 * t, rise)
            amp[rise + wide_nt1 + gap] = 0.0
            add(f"halo: nt1={wide_nt1}, a rise at {rise}, the next below nt1 + {gap} on",
                amp, (frac, pw_half, wide_nt1, npc))
    return cases


# ---- the kernel -------------------------------------------------------------

# Per device and stream: [int32 scratch, its capacity in tiles, the scratches
# it outgrew].  Zeroed once when it grows; the kernel keeps its per-launch
# state there (words 0-1, one int64: the launches so far << TICKET_BITS |
# the tickets taken), so every launch of a shape takes the same arguments
# and a CUDA graph may replay it.  An outgrown scratch is kept, since a
# graph captured earlier may still launch on it.
_scratch = {}
TICKET_BITS = 20                    # as csrc/compat_gate.cu's kTicketBits


def _scratch_for(device: torch.device, stream: int, ntiles: int) -> list:
    key = (device.index, stream)
    entry = _scratch.get(key)
    if entry is None or entry[1] < ntiles:
        cap = 1 << max(10, (ntiles - 1).bit_length())
        entry = [torch.zeros((LIB.compat_gate_scratch_words(cap),), dtype=torch.int32,
                             device=device), cap,
                 [] if entry is None else entry[2] + [entry[0]]]
        _scratch[key] = entry
    return entry


LIB = Library("compat_gate", {
    "compat_gate_launch": (I32, (PTR, PTR, I64, F32, I32, I32, I32, I32, PTR, PTR, PTR, I32,
                                 PTR)),
    "compat_gate_scratch_words": (I64, (I64,)),
    "compat_gate_tile": (I32, (I32,)),
    "compat_gate_configs": (I32, ()),
})


def compat_gate(amp: torch.Tensor, avg: torch.Tensor, frac: float, pw_half: int,
                nt1: int, npc: int, config: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) float32 |y| and windowed average -> (trig (n,) bool,
    pulses_at (n,) int32).  ``config`` (an index of CONFIGS) overrides the
    configuration ``choose_config`` picks."""
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
    config = choose_config(n, nt1) if config is None else config
    if not 0 <= config < len(CONFIGS):
        raise ValueError(f"compat_gate has configurations 0-{len(CONFIGS) - 1}, not {config}")
    tile = config_tile(config)
    if n + nt1 + tile + 2 >= 2**31 - 1:
        raise ValueError(f"compat_gate indexes samples in int32; n={n} is too long")
    trig = torch.empty((n,), dtype=torch.bool, device=amp.device)
    pulses_at = torch.empty((n,), dtype=torch.int32, device=amp.device)
    if n == 0:
        return trig, pulses_at
    ntiles = -(-n // tile)
    stream = torch.cuda.current_stream(amp.device).cuda_stream
    entry = _scratch_for(amp.device, stream, ntiles) if ntiles > 1 else None
    try:
        launch("compat_gate", LIB.compat_gate_launch, amp.device, amp.data_ptr(),
               avg.data_ptr(), n, frac, pw_half, nt1, npc, config, trig.data_ptr(),
               pulses_at.data_ptr(), entry[0].data_ptr() if entry else None,
               entry[1] if entry else 0)
    except RuntimeError:
        _scratch.pop((amp.device.index, stream), None)
        raise
    keep("compat_gate", (amp, avg), (frac, pw_half, nt1, npc))
    return trig, pulses_at


def compat_gate_for_cfg(amp: torch.Tensor, avg: torch.Tensor, cfg: ReaderConfig):
    return compat_gate(amp, avg, cfg.thresh_fraction, cfg.n_samples_pw // 2,
                       cfg.n_samples_t1, cfg.num_pulses_command)
