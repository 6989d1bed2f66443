"""The native gate's triggers: each block's first trigger and the PIE pulse
count at it, from the packed flags, in one kernel launch.

Counterpart of the pulse count, the trigger test and the block-first pad of
``gen2_rfid_tpu/dsp/gate.py::gate_detect``'s native branch: the segmented
doubling scan ``_rises_since_reset`` (:108-137) and the ``amin`` over blocks
of ``bsz`` samples (:282-305); no Pallas kernel.  From the packed flags
(kernels/gate_stack.py: RISE, QUALIFY, MARKER, QUIET) it gives, for each
block, its first trigger sample (the trigger's rise + nt1 + 1, n where the
block has none) and the pulse count at that rise (0 where none), with the
count of all triggers and the pulse count at max(n - nt1 - 2, 0), which the
event table's invalid slots keep.  Below 8 samples a block is one sample,
as ``gate_detect`` takes no blocks there.

``gate_pulses`` launches ``csrc/gate_pulses.cu`` on a CUDA tensor and raises
on any other: the CPU runs the plain version, ``dsp/gate.py::
gate_pulses_plain`` (the doubling scan and the pad over whole arrays), which
the tests and ``chip_smoke.py`` hold the kernel to bit for bit.

The kernel gives each thread block a tile of samples and a left halo at
least the scan's window long, turns the flags into 32-bit mask words and
counts with a popcount prefix and the last word holding a reset (the header
of ``csrc/gate_pulses.cu`` has the design).  ``gate_pulses_model`` is a numpy
model of that decomposition at the kernel's tiles, held to the plain version
by the tests; the decode never calls it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import keep
from ._build import I32, I64, PTR, Library, launch
from .gate_stack import MARKER, QUALIFY, QUIET, RISE

THREADS = 256        # csrc/gate_pulses.cu's kThreads
MIN_WORDS = 2        # its kMinWords
SMEM_LIMIT = 227 * 1024


def block_step(bsz: int) -> int:
    """Samples a block the kernel takes: ``bsz``, or 1 below 8."""
    return bsz if bsz >= 8 else 1


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def tile_geometry(window: int, bsz: int) -> Tuple[int, int, int, int]:
    """(halo, tile, words a thread, shared bytes) of a launch, as
    ``csrc/gate_pulses.cu::geometry`` sizes it from the window and block."""
    step = block_step(bsz)
    if not (_pow2(window) and _pow2(step) and step <= 512):
        raise ValueError(f"gate_pulses takes a power-of-two window and block (block <= 512), "
                         f"got window {window}, bsz {bsz}")
    halo = max(window, step, 32)
    wpt = max(MIN_WORDS, halo // 2048)
    tile = 32 * THREADS * wpt - halo
    smem = THREADS * wpt * 16 + tile // 32 * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"gate_pulses cannot tile window {window}: {smem} B of shared memory")
    return halo, tile, wpt, smem


# ---- the Python model of the kernel ---------------------------------------

def _words(bits: np.ndarray) -> np.ndarray:
    """(32 m,) bool -> (m,) uint32: bit b of word w is sample 32 w + b."""
    return np.packbits(bits, bitorder="little").view("<u4")


def _popc(w: np.ndarray) -> np.ndarray:
    return np.unpackbits(w.astype("<u4").view(np.uint8)).reshape(-1, 32).sum(1).astype(np.int64)


def _high_bit(w: np.ndarray) -> np.ndarray:
    """Index of each nonzero word's highest set bit (31 - clz)."""
    w = w.astype(np.int64)
    hb = np.zeros(w.shape, np.int64)
    for s in (16, 8, 4, 2, 1):
        up = (w >> (hb + s)) != 0
        hb += s * up
    return hb


def _upto(b: np.ndarray) -> np.ndarray:
    """Mask of bits 0..b of a word."""
    return ((np.int64(2) << b) - 1) & 0xFFFFFFFF


def gate_pulses_model(flags: torch.Tensor, nt1: int, npc: int, bsz: int, window: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Numpy model of the kernel: its tiles and halo, the three mask words,
    the popcount prefix P and the last-reset word L of each tile, each
    candidate's count from two prefix lookups, and each block's first
    trigger.  Same outputs as ``gate_pulses``."""
    f = flags.detach().cpu().numpy().astype(np.int64)
    n = f.size
    step = block_step(bsz)
    halo, tile, _, _ = tile_geometry(window, bsz)
    nb = -(-n // step)
    cand = np.full(nb, n, np.int64)
    pulses = np.zeros(nb, np.int64)
    n_trig, p_inv = 0, 0
    q = max(n - nt1 - 2, 0)
    for t0 in range(0, n, tile):
        idx = np.arange(t0 - halo, t0 + tile)
        v = np.where((idx >= 0) & (idx < n), f[np.clip(idx, 0, max(n - 1, 0))], 0)
        rise = (v & RISE) != 0
        reset = (rise & ((v & QUALIFY) == 0)) | ((v & MARKER) != 0)
        c_w = _words(rise & ~reset).astype(np.int64)
        r_w = _words(reset).astype(np.int64)
        k_w = _words(rise & ((v & QUIET) != 0))[halo // 32:]
        pc = _popc(c_w)
        p_w = np.concatenate([[0], np.cumsum(pc)[:-1]])
        l_w = np.maximum.accumulate(np.where(r_w != 0, np.arange(r_w.size), -1))

        def rises_to(x):
            return p_w[x >> 5] + _popc(c_w[x >> 5] & _upto(x & 31))

        def count(li):
            w = li >> 5
            here = r_w[w] & _upto(li & 31)
            lw = l_w[w - 1]
            before = np.where(lw >= 0, lw * 32 + _high_bit(r_w[np.maximum(lw, 0)]), -1)
            last = np.where(here != 0, w * 32 + _high_bit(here), before)
            return rises_to(li) - rises_to(np.maximum(last, li - window))

        s = np.flatnonzero(np.unpackbits(k_w.view(np.uint8), bitorder="little"))
        s = s[t0 + s < n - nt1 - 1]
        c = count(halo + s) if s.size else np.zeros(0, np.int64)
        hit = c > npc
        trig_s, trig_c = s[hit], c[hit]
        n_trig += trig_s.size
        if t0 <= q < t0 + tile:
            p_inv = int(count(np.array([halo + q - t0]))[0])
        blocks, first = np.unique(trig_s // step, return_index=True)
        gb = t0 // step + blocks
        cand[gb] = t0 + trig_s[first] + nt1 + 1
        pulses[gb] = trig_c[first]
    as32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return as32(cand), as32(pulses), as32([n_trig, p_inv])


# ---- inputs that stress the kernel -----------------------------------------

def random_flags(n: int, seed: int, rise: float = 0.05, unqualified: float = 0.02,
                 marker: float = 0.002, quiet: float = 0.3) -> torch.Tensor:
    """(n,) int32 packed flags drawn per sample: a rise with probability
    ``rise``, unqualified (a reset) with ``unqualified`` of the rises, a
    marker (a reset) with ``marker``, quiet after with ``quiet``."""
    rng = np.random.default_rng(seed)
    r = rng.random(n) < rise
    qual = r & (rng.random(n) >= unqualified)
    m = rng.random(n) < marker
    z = rng.random(n) < quiet
    return torch.from_numpy((RISE * r + QUALIFY * qual + MARKER * m + QUIET * z)
                            .astype(np.int32))


def pulse_cases(nt1: int, window: int, bsz: int, seed: int = 0) -> List[Tuple[str, torch.Tensor]]:
    """(label, flags) inputs that stress the kernel's tiles at a geometry:
    resets on tile and halo boundaries, a stretch longer than the window with
    no reset, rises only in a tile's halo, n below the window, n a multiple
    of neither the block nor the tile, dense rises, and a trigger's count at
    the invalid slots' sample n - nt1 - 2."""
    halo, tile, _, _ = tile_geometry(window, bsz)
    rng = np.random.default_rng(seed)
    clean, cand = RISE | QUALIFY, RISE | QUALIFY | QUIET
    cases = []

    n = 3 * tile + 5 * halo
    f = random_flags(n, seed, rise=0.04, unqualified=0.0, marker=0.0).numpy()
    for t0 in range(0, n, tile):
        for d in (-halo - 1, -halo, -halo + 1, -1, 0, 1, 31, 32, tile - 1):
            if 0 <= t0 + d < n:
                f[t0 + d] = MARKER if d % 2 else RISE       # a marker, or an unqualified rise
    cases.append(("resets at tile and halo edges", torch.from_numpy(f)))

    n = 2 * tile + 3 * window + 7
    f = np.zeros(n, np.int32)
    f[::3] = clean
    f[rng.integers(0, n, n // 50)] = cand
    cases.append(("no reset for more than the window", torch.from_numpy(f)))

    n = 3 * tile + halo
    f = np.zeros(n, np.int32)
    for t0 in range(tile, n, tile):
        f[t0 - halo: t0: 5] = clean
        for d in (0, 1, 2, 31, 200):
            if t0 + d < n:
                f[t0 + d] = cand
    cases.append(("rises only in the halo", torch.from_numpy(f)))

    cases.append(("n below the window",
                  random_flags(max(window // 2 + 37, 8), seed + 1, rise=0.2, unqualified=0.01)))
    cases.append(("n a multiple of neither block nor tile",
                  random_flags(2 * tile + 3 * max(bsz, 1) + 5, seed + 2)))
    cases.append(("dense rises", random_flags(2 * tile + 11, seed + 3, rise=0.6,
                                              unqualified=0.05, marker=0.01, quiet=0.5)))

    n = tile + halo + 77
    f = np.zeros(n, np.int32)
    tail = max(n - nt1 - 2, 0)
    f[max(tail - 6 * 7, 0): tail + 1: 7] = cand
    f[tail] = clean
    cases.append(("pulses at n - nt1 - 2", torch.from_numpy(f)))
    return cases


# ---- the wrapper -----------------------------------------------------------

LIB = Library("gate_pulses", {
    "gate_pulses_launch": (I32, (PTR, I64, I32, I32, I32, I32, PTR, PTR, PTR, PTR)),
    "gate_pulses_geometry": (I32, (I32, I32, PTR)),
})


def kernel_geometry(window: int, bsz: int) -> Tuple[int, int, int, int]:
    """``tile_geometry`` as the built kernel computes it (the card's check
    that the model and ``pulse_cases`` tile as the kernel does)."""
    out = (I64 * 4)()
    err = LIB.gate_pulses_geometry(window, block_step(bsz), out)
    if err:
        raise ValueError(f"gate_pulses cannot tile window {window}, bsz {bsz}")
    return tuple(int(v) for v in out)


def gate_pulses(flags: torch.Tensor, nt1: int, npc: int, bsz: int, window: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n,) int32 packed flags on CUDA -> (cand, pulses, counts): each block's
    first trigger sample and its pulse count, (ceil(n / step),) int32 each
    (step ``block_step(bsz)``), and (2,) int32 (triggers, pulses at
    max(n - nt1 - 2, 0)).  ``window`` is the scan's reach, a power of two."""
    if flags.dim() != 1:
        raise ValueError(f"gate_pulses takes (n,) flags, got {tuple(flags.shape)}")
    if flags.device.type != "cuda":
        raise ValueError(f"gate_pulses launches its CUDA kernel, not on {flags.device}: "
                         "the CPU runs dsp/gate.py::gate_pulses_plain")
    if flags.dtype != torch.int32:
        raise ValueError("gate_pulses takes int32 flags")
    if nt1 < 0:
        raise ValueError(f"gate_pulses needs nt1 >= 0, got {nt1}")
    halo, tile, _, _ = tile_geometry(window, bsz)
    flags = flags.contiguous()
    n = flags.shape[0]
    if n + nt1 + 2 * (halo + tile) >= 2**31 - 1:
        raise ValueError(f"gate_pulses indexes int32 samples; n={n} is too long")
    step = block_step(bsz)
    dev = flags.device
    cand = torch.empty((-(-n // step),), dtype=torch.int32, device=dev)
    pulses = torch.empty_like(cand)
    if n == 0:
        return cand, pulses, torch.zeros((2,), dtype=torch.int32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    launch("gate_pulses", LIB.gate_pulses_launch, dev, flags.data_ptr(), n, nt1, npc, step,
           window, cand.data_ptr(), pulses.data_ptr(), counts.data_ptr())
    keep("gate_pulses", flags, (nt1, npc, bsz, window))
    return cand, pulses, counts
