"""Fused gate flag stack: y -> amp -> threshold -> packed edge flags.

Port of the Pallas TPU kernel ``gen2_rfid_tpu/kernels/gate_stack.py``.  From
post-decimation planar (2, Ny) float32 I/Q it computes, per sample, the
native gate's flags (dsp/gate.py) packed into int32: bit 0 rise, bit 1
qualify, bit 2 marker, bit 3 quiet_after.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/gate_stack.cu``; on a CPU tensor it runs ``gate_stack_plain``, which
has the semantics of ``native_flags_reference`` (the W-sample average in
``run_sum``'s dyadic order, ``thresh = (msum / W) * frac`` as two roundings)
with |y| computed as ``sqrt(re*re + im*im)``, correctly rounded.  The two
give equal flags.

The kernel has two paths.  ``ReaderConfig``'s widths (W 100, pw/2 2, nt1
96) compile as constants into a warp stream: each warp streams a run of
32-sample words, lane l holding sample 32t + l of step t.  The dyadic
levels are shifts with a carry from the last step (a warp shuffle for
shifts under 32, the same lane some steps back for multiples of 32);
``above`` is one ballot word a step; rise and qualify are word operations
over this word and the last; marker carries the index of the last zero of
``above`` from word to word and is ballotted into a word; quiet for word k
is marker words k+3 and k+4 shifted by (nt1+1) % 32, so a word's flags are
stored 4 steps after they are computed.  A run starts 7 words early (4
until the sum is exact, 3 of marker lookback) with its carries at zero.
``gate_stack_warp_plain`` models it in PyTorch for any widths (pw/2 <= 31).

Every other width (Miller, BLF other than 40 kHz, other sample rates) takes
the segment kernel, with the widths as runtime arguments: a block owns a
contiguous segment of words and walks it in 1024-sample tiles, paying the
W-1 + nt1 lookback and the nt1+1 look-ahead once a segment.  On the H100 a
block has 227 KB of shared memory, so each dyadic level keeps only a buffer
of the tile and of the history it is read back at; ``above`` is a ballot word,
and the tile's words are scanned for their last zero and last one, carried
from tile to tile, so marker and qualify are word operations at any nt1
and pw/2.  ``gate_stack_segment_plain`` models it in PyTorch and
``segment_smem_bytes`` its shared memory.  The tests hold both models to
``gate_stack_plain`` and to the JAX oracle.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import keep, launches, stack_bodies
from ..config import ReaderConfig
from ..dsp.filters import magnitude, run_sum
from .gate_front import SMEM_LIMIT

RISE, QUALIFY, MARKER, QUIET = 1, 2, 4, 8
_MASK = 0xFFFFFFFF


def native_flags_from_amp(amp: torch.Tensor, avg: torch.Tensor, pw_half: int, nt1: int,
                          frac: float) -> torch.Tensor:
    """The native gate's packed flags from an amplitude and its windowed
    average (gen2_rfid_tpu/dsp/gate.py:184, 216-234, 273-274): threshold
    ``avg * frac``, rise, qualify (the pw/2+1 samples before a rise all
    below), marker (an nt1+1-long all-above run ends here) and quiet (one
    starts after the next sample).  (N,) float32 -> (N,) int32."""
    n = amp.shape[0]
    dev = amp.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    arange = torch.arange(n, dtype=torch.int32, device=dev)
    thresh = avg * torch.tensor(frac, dtype=torch.float32, device=dev)
    above = amp > thresh
    prev_above = torch.cat([above.new_zeros(1), above[:-1]])
    rise = above & ~prev_above
    below_run = run_sum(~prev_above, pw_half + 1)
    need = torch.clamp(arange.to(torch.float32), max=float(pw_half + 1))
    qualify = rise & (below_run >= need) & (arange >= pw_half)
    above_run = run_sum(above, nt1 + 1)
    marker = above_run >= float(nt1 + 1)
    shifted = torch.cat([above_run[nt1 + 1:], above_run.new_zeros(nt1 + 1)])[:n]
    quiet = shifted >= float(nt1 + 1)
    i32 = torch.int32
    return (rise.to(i32) + QUALIFY * qualify.to(i32) + MARKER * marker.to(i32)
            + QUIET * quiet.to(i32))


def gate_stack_plain(y2: torch.Tensor, win: int, pw_half: int, nt1: int,
                     frac: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (2, Ny) -> (Ny,) int32 flags:
    |y|, its ``run_sum`` average, then ``native_flags_from_amp``."""
    amp = magnitude(y2[0], y2[1])
    # A tensor divisor keeps the division IEEE on CUDA too (PyTorch turns
    # division by a Python scalar into a reciprocal multiply there).
    avg = run_sum(amp, win) / torch.tensor(float(win), dtype=torch.float32, device=y2.device)
    return native_flags_from_amp(amp, avg, pw_half, nt1, frac)


# ---- the warp stream, modelled on the CPU ---------------------------------

def stream_geometry(win: int, pw_half: int, nt1: int):
    """(left, delay, s, sh): the words a warp computes before its run (until
    the sum is exact, then the marker's lookback, at least one) and after it
    (quiet's look-ahead), and quiet's shift nt1+1 = 32 s + sh in words and
    bits."""
    def c32(x):
        return -(-x // 32)

    s, sh = divmod(nt1 + 1, 32)
    return c32(win - 1) + max(c32(nt1), 1), s + (sh != 0), s, sh


def _carry_shift(p: torch.Tensor, s: int) -> torch.Tensor:
    """A (warps, steps, 32) lane-strided tensor shifted by s samples: lane l
    of step t takes sample 32t + l - s.  The lanes rotate by s % 32; lanes
    at or above it take this step's rotated value and the rest the step
    before's; then s // 32 steps back.  Zero before a warp's first step,
    where the kernel's carries start."""
    q, o = divmod(s, 32)
    rot = torch.roll(p, o, dims=2)
    if o:
        prev = torch.cat([torch.zeros_like(rot[:, :1]), rot[:, :-1]], dim=1)
        rot = torch.where(torch.arange(32) >= o, rot, prev)
    if q:
        rot = torch.cat([torch.zeros_like(rot[:, :q]), rot[:, :-q]], dim=1)
    return rot


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) bool -> (...) int64 word, lane l in bit l: a ballot."""
    return (bits.to(torch.int64) << torch.arange(32)).sum(-1)


def _unpack(words: torch.Tensor) -> torch.Tensor:
    return (words[..., None] >> torch.arange(32)) & 1


def _high_bit(w: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each positive word below 2^32
    (31 - clz): float64 holds log2 of such words far enough from the next
    integer."""
    return torch.log2(w.clamp(min=1).to(torch.float64)).floor().to(torch.int64)


def _funnel_l(lo: torch.Tensor, hi: torch.Tensor, d: int) -> torch.Tensor:
    """The high word of (hi:lo) << d, 1 <= d <= 32 (__funnelshift_l)."""
    return ((hi << d) | (lo >> (32 - d))) & _MASK


def gate_stack_warp_plain(y2: torch.Tensor, win: int, pw_half: int, nt1: int,
                          frac: float, run: int = 29) -> torch.Tensor:
    """The CUDA kernel's warp stream on the CPU: (2, Ny) -> (Ny,) int32
    flags, each warp owning ``run`` words of output.  Equal to
    ``gate_stack_plain`` for any widths with pw_half <= 31."""
    if pw_half > 31 or run < 1:
        raise ValueError("the warp stream needs pw_half <= 31 and run >= 1")
    n = y2.shape[1]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32)
    left, delay, s, sh = stream_geometry(win, pw_half, nt1)
    nwords = -(-n // 32)
    nw = -(-nwords // run)
    steps = left + run + delay
    lane = torch.arange(32)
    k0 = torch.arange(nw) * run                       # each warp's first output word
    idx = ((k0 - left) * 32)[:, None, None] + 32 * torch.arange(steps)[None, :, None] + lane
    ok = (idx >= 0) & (idx < n)
    re = torch.where(ok, y2[0].to(torch.float32)[idx.clamp(0, n - 1)], 0.0)
    im = torch.where(ok, y2[1].to(torch.float32)[idx.clamp(0, n - 1)], 0.0)
    amp = magnitude(re, im)

    lev = [amp]
    while (1 << len(lev)) <= win:
        lev.append(lev[-1] + _carry_shift(lev[-1], 1 << (len(lev) - 1)))
    msum, off = None, 0
    for j in reversed(range(len(lev))):
        if win >> j & 1:
            term = _carry_shift(lev[j], off)
            msum = term if msum is None else msum + term
            off += 1 << j
    thresh = (msum / torch.tensor(float(win), dtype=torch.float32)
              * torch.tensor(frac, dtype=torch.float32))
    a = _pack(amp > thresh)                            # (warps, steps) above words

    # Marker: the last zero of `above` at or before each lane, carried from
    # word to word from local sample -1.
    upto = (2 << lane) - 1
    lz = torch.full((nw,), -1, dtype=torch.int64)
    m = torch.zeros_like(a)
    for t in range(steps):
        z = (~a[:, t] & _MASK)[:, None] & upto
        zi = torch.where(z != 0, 32 * t + _high_bit(z), lz[:, None])
        m[:, t] = _pack(32 * t + lane - zi >= nt1 + 1)
        na = ~a[:, t] & _MASK
        lz = torch.where(na != 0, 32 * t + _high_bit(na), lz)

    ks = torch.arange(left, left + run)
    ak, ap = a[:, ks], a[:, ks - 1]
    rise = ak & ~_funnel_l(ap, ak, 1)
    ones = torch.zeros_like(ak)
    for d in range(1, pw_half + 2):
        ones |= _funnel_l(ap, ak, d)
    qual = rise & ~ones
    low = (1 << pw_half) - 1
    at = torch.where(_unpack(ak & low).sum(-1) <= 1, 1 << pw_half, 0)
    first = (k0[:, None] + ks - left) == 0
    qual = torch.where(first, (qual & ~low & ~(1 << pw_half)) | (rise & at), qual)
    quiet = (((m[:, ks + s] >> sh) | (m[:, ks + s + 1] << (32 - sh))) & _MASK if sh
             else m[:, ks + s])
    flags = (_unpack(rise) | _unpack(qual) << 1 | _unpack(m[:, ks]) << 2
             | _unpack(quiet) << 3)
    return flags.reshape(-1)[:n].to(torch.int32)


# ---- the segment kernel, modelled on the CPU --------------------------------

SEG_TILE = 1024      # samples a block takes a tile: 256 threads x 4
SEG_MAX_LEV = 13     # dyadic levels the kernel unrolls: W < 8192
_NONE = -(1 << 30)   # "no such sample" for the carried last zero / last one


class SegmentGeometry(NamedTuple):
    nlev: int           # run_sum's levels 0 .. floor(log2 W)
    off: tuple          # combine offset of level j, -1 where bit j of W is clear
    hist: tuple         # history floats of level j's buffer (0: the top level keeps none)
    left: int           # words computed before a segment's first output word
    delay: int          # words from computing a word to storing its flags
    s: int              # quiet's shift nt1+1 = 32 s + sh
    sh: int
    nw: int             # length of the marker / rise / qualify word rings


def segment_geometry(win: int, pw_half: int, nt1: int, tile: int = SEG_TILE) -> SegmentGeometry:
    """The segment kernel's level buffers and halos
    (``csrc/gate_stack.cu::seg_geo``).  Level j below the top keeps a buffer
    of its history, as deep as its largest lag (2^j, which level j+1 reads,
    or its combine offset) rounded up to 4 floats, and of the tile.  A
    segment starts ``left`` words early (W-1 samples until the sum is exact,
    then the flags' lookback) and runs ``delay`` words past its end
    (quiet's look-ahead)."""
    nlev = win.bit_length()
    off = tuple(win & ~((2 << j) - 1) if win >> j & 1 else -1 for j in range(nlev))
    hist = tuple(-(-max(1 << j, off[j]) // 4) * 4 for j in range(nlev - 1)) + (0,)
    left = -(-(win - 1 + max(nt1, pw_half + 1)) // 32)
    s, sh = divmod(nt1 + 1, 32)
    delay = s + (sh != 0)
    nw = 1 << (tile // 32 + delay - 1).bit_length()
    return SegmentGeometry(nlev, off, hist, left, delay, s, sh, nw)


def segment_smem_bytes(win: int, pw_half: int, nt1: int) -> int:
    """Shared memory a block of the segment kernel takes (mirrors
    ``csrc/gate_stack.cu::seg_smem``): the level buffers, two tiles of
    ``above`` words and the marker, rise and qualify word rings."""
    g = segment_geometry(win, pw_half, nt1)
    bufs = sum(h + SEG_TILE for h in g.hist[:-1])
    return 4 * (bufs + 2 * (SEG_TILE // 32) + 3 * g.nw)


def segment_unsupported(win: int, pw_half: int, nt1: int):
    """Why the segment kernel cannot take these widths, or None."""
    if win < 1 or pw_half < 0 or nt1 < 0:
        return f"widths must be W >= 1, pw/2 >= 0, nt1 >= 0 (got {win}, {pw_half}, {nt1})"
    if win.bit_length() > SEG_MAX_LEV:
        return f"W={win} needs {win.bit_length()} dyadic levels; the kernel unrolls {SEG_MAX_LEV}"
    if pw_half >= SEG_TILE:
        return f"pw/2={pw_half} must be below the kernel's {SEG_TILE}-sample tile"
    smem = segment_smem_bytes(win, pw_half, nt1)
    if smem > SMEM_LIMIT:
        return f"widths {(win, pw_half, nt1)} need {smem} bytes of shared memory, over {SMEM_LIMIT}"
    return None


def gate_stack_segment_plain(y2: torch.Tensor, win: int, pw_half: int, nt1: int,
                             frac: float, seg: int = 64, tile: int = SEG_TILE) -> torch.Tensor:
    """The CUDA segment kernel on the CPU: (2, Ny) -> (Ny,) int32 flags, each
    block owning ``seg`` words of output and walking them in tiles of
    ``tile`` samples.  Segments start ``left`` words early with every buffer
    and carry at zero; a tile stores |y| and each level below the top into
    its buffer after the level's history, reads each level's lag and each
    combine term back, ballots ``above`` into words, scans the words for
    their last zero and last one with the carries of earlier tiles, moves
    each buffer's newest history to its front, and stores the flags of the
    words ``delay`` behind.  Equal to ``gate_stack_plain``."""
    if seg < 1 or tile < 32 or tile % 32 or pw_half >= tile:
        raise ValueError("the segment model needs seg >= 1 and tile a multiple of 32 "
                         "above pw_half")
    n = y2.shape[1]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32)
    g = segment_geometry(win, pw_half, nt1, tile)
    tw = tile // 32
    nwords = -(-n // 32)
    nseg = -(-nwords // seg)
    k0 = torch.arange(nseg) * seg                       # each segment's first output word
    kend = g.left + (nwords - k0).clamp(max=seg)        # its end, in local words
    c0 = (k0 - g.left) * 32                             # global sample of local sample 0
    ntiles = int(-(-(int(kend.max()) + g.delay) // tw))
    re, im = y2[0].to(torch.float32), y2[1].to(torch.float32)
    wf = torch.tensor(float(win), dtype=torch.float32)
    fr = torch.tensor(frac, dtype=torch.float32)
    bufs = [torch.zeros(nseg, h + tile) for h in g.hist[:-1]]
    aring = torch.zeros(nseg, 2 * tw, dtype=torch.int64)
    mring, rring, qring = (torch.zeros(nseg, g.nw, dtype=torch.int64) for _ in range(3))
    lz = torch.full((nseg,), _NONE, dtype=torch.int64)  # last zero before the tile
    lo = torch.full((nseg,), _NONE, dtype=torch.int64)  # last one before the tile
    ap = torch.zeros(nseg, dtype=torch.int64)           # the word before the tile
    out = torch.zeros(nwords * 32, dtype=torch.int32)
    lane = torch.arange(32)
    upto = (2 << lane) - 1
    i = torch.arange(tile)
    # The ones of [0, pw/2) decide qualify at sample pw/2 (need = pw/2 there).
    head = torch.arange(pw_half)
    for t in range(ntiles):
        q = t * tile + i                                # local samples of the tile
        gp = c0[:, None] + q
        ok = (gp >= 0) & (gp < n)
        at = gp.clamp(0, n - 1)
        amp = magnitude(torch.where(ok, re[at], 0.0), torch.where(ok, im[at], 0.0))
        cur = amp
        for j in range(g.nlev - 1):
            h = g.hist[j]
            bufs[j][:, h:] = cur
            cur = cur + bufs[j][:, h - (1 << j) + i]
        msum = cur
        for j in reversed(range(g.nlev - 1)):
            if g.off[j] >= 0:
                msum = msum + bufs[j][:, g.hist[j] - g.off[j] + i]
        for j in range(g.nlev - 1):
            bufs[j][:, :g.hist[j]] = bufs[j][:, tile:tile + g.hist[j]].clone()
        above = ok & (amp > msum / wf * fr)
        a = _pack(above.reshape(nseg, tw, 32))          # (segments, words) ballots
        kw = t * tw + torch.arange(tw)                  # local word indices
        aring[:, kw % (2 * tw)] = a
        wpos = 32 * kw
        na = ~a & _MASK
        z = torch.where(na != 0, wpos + _high_bit(na), _NONE)
        o = torch.where(a != 0, wpos + _high_bit(a), _NONE)
        zinc = torch.maximum(torch.cummax(z, 1).values, lz[:, None])
        oinc = torch.maximum(torch.cummax(o, 1).values, lo[:, None])
        zex = torch.cat([lz[:, None], zinc[:, :-1]], 1)
        oex = torch.cat([lo[:, None], oinc[:, :-1]], 1)
        apw = torch.cat([ap[:, None], a[:, :-1]], 1)
        lz, lo, ap = zinc[:, -1], oinc[:, -1], a[:, -1]
        pos = wpos[:, None] + lane                      # (words, 32) local samples
        zb = na[..., None] & upto
        zi = torch.where(zb != 0, wpos[:, None] + _high_bit(zb), zex[..., None])
        mk = _pack(pos - zi >= nt1 + 1)
        rise = a & ~(((a << 1) | (apw >> 31)) & _MASK)
        ob = a[..., None] & (upto >> 1)
        lob = torch.where(ob != 0, wpos[:, None] + _high_bit(ob), oex[..., None])
        loc = head - c0[:, None]                        # local samples of [0, pw/2)
        ones = ((aring.gather(1, (loc.clamp(min=0) // 32) % (2 * tw))
                 >> (loc.clamp(min=0) % 32)) & 1).sum(1)
        gpos = c0[:, None, None] + pos
        qb = torch.where(gpos > pw_half, pos - lob >= pw_half + 2,
                         (gpos == pw_half) & (ones <= 1)[:, None, None])
        qual = rise & _pack(qb)
        mring[:, kw % g.nw], rring[:, kw % g.nw], qring[:, kw % g.nw] = mk, rise, qual
        ko = t * tw - g.delay + torch.arange(tw)        # the words whose flags are whole
        m0 = mring[:, (ko + g.s) % g.nw]
        m1 = mring[:, (ko + g.s + 1) % g.nw]
        quiet = ((m0 >> g.sh) | (m1 << (32 - g.sh))) & _MASK if g.sh else m0
        f = (_unpack(rring[:, ko % g.nw]) | _unpack(qring[:, ko % g.nw]) << 1
             | _unpack(mring[:, ko % g.nw]) << 2 | _unpack(quiet) << 3)
        keep = (ko >= g.left) & (ko < kend[:, None])
        dst = (k0[:, None] + ko - g.left)[..., None] * 32 + lane
        out[dst[keep]] = f[keep].to(torch.int32)
    return out[:n]


READER = (100, 2, 96, 0.75)        # ReaderConfig(): the stream kernel's widths
BLF640 = (1000, 24, 960, 0.75)     # FM0 at 8 Msps, decim 2 (bench_configs.py::case_blf640)
BLF160 = (500, 12, 480, 0.75)      # for_link(160e3, dr=1, decim=1) (case_blf160); miller4's too
MILLER2 = (250, 6, 240, 0.75)      # Miller-2 at 2 Msps, decim 2 (case_miller2)
TARI625 = (2000, 12, 1920, 0.75)   # for_link(640e3, tari_us=6.25, dr=1, adc_rate=8e6, decim=1)
M8_BLF320 = (2000, 25, 1920, 0.75)  # for_link(320e3, tari_us=12.5, dr=1, M=8, 8 Msps, decim 1)
FM0_8M = (2000, 48, 1920, 0.75)    # ReaderConfig(adc_rate=8e6, decim=1)
FM0_16M = (4000, 96, 3840, 0.75)   # ReaderConfig(adc_rate=16e6, decim=1)
SEGMENT_GEOS = {"miller2": MILLER2, "blf160": BLF160, "blf640": BLF640, "tari625": TARI625,
                "miller8_blf320": M8_BLF320, "fm0_8msps": FM0_8M, "fm0_16msps": FM0_16M}


def burst_capture(n: int, seed: int, longest: int = 399) -> torch.Tensor:
    """(2, n) float32 y: CW bursts of 1-399 samples at levels 0.05, 1 and 3
    with a little noise, so that every flag is set: long above runs (marker,
    quiet), edges after gaps (rise, qualify) and short gaps.  With
    ``longest`` over 399, about a third of the bursts are 400-``longest``
    samples long, for marker and quiet at a wide nt1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lev = np.ones(n, np.float32)
    pos = 0
    while pos < n:
        long_one = longest > 399 and rng.random() < 0.3
        span = int(rng.integers(400, longest + 1) if long_one else rng.integers(1, 400))
        lev[pos:pos + span] = rng.choice([0.05, 1.0, 3.0])
        pos += span
    y = rng.normal(size=(2, n)) * 0.05 + lev * np.array([[1.0], [0.5]])
    return torch.from_numpy(y.astype(np.float32))


def _noise(n, seed):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed).normal(size=(2, n)).astype(np.float32))


def stream_cases():
    """(label, y2, (win, pw_half, nt1, frac), run) on the CPU: the inputs the
    warp stream is held to, by the tests and on the card.  Noise at lengths
    around a word and below a run's 7-word halo; lengths on a run boundary
    and one either side; bursts with runs of 1, 5 and 29 words; ties (amp
    equal to its threshold from sample 99 on), all above, all below, a
    stretch of tiny samples and an infinite one; the blf640 and 160 kHz
    widths."""
    cases = [(f"noise n={n}", _noise(n, n), READER, 29) for n in (1, 31, 32, 33, 200)]
    for run in (5, 29):
        for n in (64 * run - 1, 64 * run, 64 * run + 1):
            cases.append((f"noise n={n} run={run}", _noise(n, n + run), READER, run))
    for run in (1, 5, 29):
        cases.append((f"bursts n=20000 run={run}", burst_capture(20000, run), READER, run))
    const = torch.tensor([[1.0], [0.0]]).expand(2, 3000).contiguous()
    cases.append(("ties n=3000", const, READER[:3] + (1.0,), 29))
    cases.append(("all above n=3000", const * torch.tensor([[1.0], [0.5]]), READER, 29))
    cases.append(("all below n=3000", torch.zeros(2, 3000), READER, 29))
    # Outside the stream's fast root and division (|y|^2 or the sum below
    # 2^-100, or infinite): the warps that meet them recompute with IEEE.
    tiny = burst_capture(5000, 11)
    tiny[:, 1000:2500] *= 1e-20
    cases.append(("tiny stretch n=5000", tiny, READER, 13))
    inf = burst_capture(5000, 12)
    inf[0, 3000] = float("inf")
    cases.append(("an infinity n=5000", inf, READER, 13))
    for label, geo in (("blf640", BLF640), ("blf160", BLF160)):
        for run in (4, 29):
            cases.append((f"{label} bursts n=30001 run={run}", burst_capture(30001, run), geo, run))
        cases.append((f"{label} noise n=5000", _noise(5000, 7), geo, 29))
    return cases


def segment_cases():
    """(label, y2, (win, pw_half, nt1, frac), run) on the CPU: the inputs the
    segment kernel is held to, by the tests and on the card, ``run`` being
    the words a segment takes.  Bursts (up to 3 nt1 long) at every width
    of ``SEGMENT_GEOS`` with segments of 8 words (shorter than every halo) and of 64; noise at
    lengths on a segment and tile boundary (64 words = 2 tiles) and one
    either side; ties, all above, all below, a stretch of tiny samples and
    an infinite one at the blf640 widths."""
    cases = []
    for label, geo in SEGMENT_GEOS.items():
        for run in (8, 64):
            y2 = burst_capture(30001, geo[0] + run, longest=max(399, 3 * geo[2]))
            cases.append((f"{label} bursts n=30001 run={run}", y2, geo, run))
    for n in (6143, 6144, 6145):
        cases.append((f"blf640 noise n={n} run=64", _noise(n, n), BLF640, 64))
    const = torch.tensor([[1.0], [0.0]]).expand(2, 5000).contiguous()
    cases.append(("blf640 ties n=5000", const, BLF640[:3] + (1.0,), 13))
    cases.append(("blf640 all above n=5000", const * torch.tensor([[1.0], [0.5]]), BLF640, 13))
    cases.append(("blf640 all below n=5000", torch.zeros(2, 5000), BLF640, 13))
    tiny = burst_capture(5000, 11)
    tiny[:, 1000:2500] *= 1e-20
    cases.append(("blf640 tiny stretch n=5000", tiny, BLF640, 13))
    inf = burst_capture(5000, 12)
    inf[0, 3000] = float("inf")
    cases.append(("blf640 an infinity n=5000", inf, BLF640, 13))
    return cases


# ---- the wrapper -----------------------------------------------------------

def _library():
    from ._build import library

    lib = library("gate_stack")
    lib.gate_stack_launch.restype = ctypes.c_int
    lib.gate_stack_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gate_stack_check_arith.restype = ctypes.c_int
    lib.gate_stack_check_arith.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gate_stack_shape.restype = ctypes.c_int
    lib.gate_stack_shape.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return lib


def gate_stack_flags(y2: torch.Tensor, win: int, pw_half: int, nt1: int,
                     frac: float, run: int = 0) -> torch.Tensor:
    """(2, Ny) float32 planar I/Q -> (Ny,) int32 packed flags.  On CUDA,
    ``run`` is the words of 32 outputs a warp streams at ReaderConfig's
    widths, or a block's segment at any other (0: chosen from Ny and the
    card); widths the segment kernel cannot take raise ``ValueError``.  A
    CPU tensor takes the plain version."""
    if y2.dim() != 2 or y2.shape[0] != 2:
        raise ValueError(f"gate_stack takes (2, Ny) planar I/Q, got {tuple(y2.shape)}")
    if run < 0:
        raise ValueError("gate_stack's run is a count of words, >= 0")
    if y2.device.type == "cpu":
        return gate_stack_plain(y2.to(torch.float32), win, pw_half, nt1, frac)
    if y2.device.type != "cuda":
        raise ValueError(f"gate_stack runs on cuda or cpu, not {y2.device}")
    if y2.dtype != torch.float32 or not y2.is_contiguous():
        raise ValueError("gate_stack takes a contiguous float32 tensor")
    body = "stream" if (win, pw_half, nt1) == READER[:3] else "segment"
    if body == "segment":
        why = segment_unsupported(win, pw_half, nt1)
        if why:
            raise ValueError(f"gate_stack: {why}")
    ny = y2.shape[1]
    flags = torch.empty((ny,), dtype=torch.int32, device=y2.device)
    if ny == 0:
        return flags
    lib = _library()
    with torch.cuda.device(y2.device):
        stream = torch.cuda.current_stream(y2.device).cuda_stream
        err = lib.gate_stack_launch(y2.data_ptr(), ny, win, pw_half, nt1, frac, run,
                                    flags.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gate_stack kernel launch failed: CUDA error {err}")
    launches["gate_stack"] += 1
    stack_bodies[body] += 1
    keep("gate_stack", y2, (win, pw_half, nt1, frac, run))
    return flags


def gate_stack_shape(ny: int, win: int, pw_half: int, nt1: int, run: int = 0) -> dict:
    """What a launch would take on the current card, launching nothing: grid,
    threads a block, resident blocks an SM, SMs, the run in words (a warp's
    in the stream kernel, a block's segment in the segment kernel) and
    shared memory a block."""
    out = (ctypes.c_longlong * 6)()
    err = _library().gate_stack_shape(ny, win, pw_half, nt1, run, out)
    if err:
        raise RuntimeError(f"gate_stack shape query failed: CUDA error {err}")
    keys = ("grid", "threads", "blocks_per_sm", "sms", "run", "smem_bytes")
    return dict(zip(keys, list(out)))


def check_arith(device="cuda") -> dict:
    """The stream kernel's fast root and division by 100 against the IEEE
    ``__fsqrt_rn`` and ``__fdiv_rn`` on every float of their range (0 and
    [2^-100, FLT_MAX]), on the card: the count of inputs where each differs
    and the smallest such input's bits (``None`` when there is none)."""
    out = torch.tensor([0, 0, -1, -1], dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        err = _library().gate_stack_check_arith(
            out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"gate_stack arithmetic check failed to launch: CUDA error {err}")
    n_sqrt, n_div, b_sqrt, b_div = out.tolist()
    return {"sqrt_differs": n_sqrt, "div_differs": n_div,
            "first_sqrt": None if b_sqrt < 0 else b_sqrt,
            "first_div": None if b_div < 0 else b_div}


def gate_stack_for_cfg(y2: torch.Tensor, cfg: ReaderConfig, **kw) -> torch.Tensor:
    return gate_stack_flags(y2, cfg.win_length, cfg.n_samples_pw // 2,
                            cfg.n_samples_t1, cfg.thresh_fraction, **kw)
