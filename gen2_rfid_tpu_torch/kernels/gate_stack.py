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

The kernel's design for ``ReaderConfig``'s widths (W 100, pw/2 2, nt1 96):
each warp streams a run of 32-sample words, lane l holding sample 32t + l of
step t.  The dyadic levels are shifts with a carry from the last step (a
warp shuffle for shifts under 32, the same lane some steps back for
multiples of 32); ``above`` is one ballot word a step; rise and qualify are
word operations over this word and the last; marker carries the index of
the last zero of ``above`` from word to word and is ballotted into a word;
quiet for word k is marker words k+3 and k+4 shifted by (nt1+1) % 32, so a
word's flags are stored 4 steps after it is computed.  A run starts 7 words
early (4 until the sum is exact, 3 of marker lookback) with its carries at
zero.  ``gate_stack_warp_plain`` models that decomposition in PyTorch for
any widths (pw/2 <= 31); the tests hold it to ``gate_stack_plain`` and to
the JAX oracle.  Other widths run the kernel's general path, which stages
each block's samples in shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import launches
from ..config import ReaderConfig
from ..dsp.filters import magnitude, run_sum

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


READER = (100, 2, 96, 0.75)        # ReaderConfig(): the stream kernel's widths
BLF640 = (1000, 24, 960, 0.75)     # FM0 at 8 Msps, decim 2 (bench_configs.py::case_blf640)
BLF160 = (500, 12, 480, 0.75)      # for_link(160e3, dr=1, decim=1) (case_blf160)


def burst_capture(n: int, seed: int) -> torch.Tensor:
    """(2, n) float32 y: CW bursts of 1-399 samples at levels 0.05, 1 and 3
    with a little noise, so that every flag is set: long above runs (marker,
    quiet), edges after gaps (rise, qualify) and short gaps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lev = np.ones(n, np.float32)
    pos = 0
    while pos < n:
        span = int(rng.integers(1, 400))
        lev[pos:pos + span] = rng.choice([0.05, 1.0, 3.0])
        pos += span
    y = rng.normal(size=(2, n)) * 0.05 + lev * np.array([[1.0], [0.5]])
    return torch.from_numpy(y.astype(np.float32))


def stream_cases():
    """(label, y2, (win, pw_half, nt1, frac), run) on the CPU: the inputs the
    warp stream is held to, by the tests and on the card.  Noise at lengths
    around a word and below a run's 7-word halo; lengths on a run boundary
    and one either side; bursts with runs of 1, 5 and 29 words; ties (amp
    equal to its threshold from sample 99 on), all above, all below, a
    stretch of tiny samples and an infinite one; the blf640 and 160 kHz
    widths."""
    import numpy as np

    def noise(n, seed):
        return torch.from_numpy(np.random.default_rng(seed).normal(size=(2, n)).astype(np.float32))

    cases = [(f"noise n={n}", noise(n, n), READER, 29) for n in (1, 31, 32, 33, 200)]
    for run in (5, 29):
        for n in (64 * run - 1, 64 * run, 64 * run + 1):
            cases.append((f"noise n={n} run={run}", noise(n, n + run), READER, run))
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
        cases.append((f"{label} noise n=5000", noise(5000, 7), geo, 29))
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
    widths (0: chosen from Ny and the card; other widths ignore it); a CPU
    tensor takes the plain version."""
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
    return flags


def gate_stack_shape(ny: int, win: int, pw_half: int, nt1: int, run: int = 0) -> dict:
    """What a launch would take on the current card, launching nothing: grid,
    threads a block, resident blocks an SM, SMs, the run in words (0 for the
    general kernel) and shared memory a block."""
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
