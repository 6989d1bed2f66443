"""The reference gate's per-sample state machine, walked from edge to edge.

Counterpart of the ``lax.scan`` in ``gen2_rfid_tpu/dsp/gate.py::
gate_detect_scan`` (:341-366), the exact sequential oracle behind
``exact_gate=True``.  From |y|, its windowed average and the threshold
fraction it gives, per sample, whether the gate triggered there and the
pulse count the FSM held (dsp/gate.py::gate_detect_scan builds the event
table from them).

On a CUDA tensor the wrapper launches ``csrc/gate_scan.cu``; on a CPU tensor
it runs ``gate_scan_plain``, a Python loop over every sample.  Both compare
``amp`` with the float32 product ``avg * frac``, so they give equal outputs.

The kernel does not walk every sample: the FSM changes state only at edges
and triggers, so the grid lists the edges first and one warp walks them, 32
a step (the rules are in the header of ``csrc/gate_scan.cu``).
``gate_scan_edges_plain`` is a Python model of its phases (decision masks
and edge list, the walk, the fill), held against ``gate_scan_plain`` by the
tests and ``chip_smoke.py``; the decode never calls it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ._build import F32, I32, I64, PTR, Library, launch

def gate_scan_plain(amp: torch.Tensor, avg: torch.Tensor, frac: float,
                    pw_half: int, nt1: int, npc: int, rn16_window: int,
                    epc_window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (trig (n,) bool, pulses_out (n,) int32).
    Each sample's decision (+1 above ``avg * frac``, -1 below, 0 equal) is
    taken on the tensors; the FSM walks them in a host loop."""
    thresh = avg * torch.tensor(frac, dtype=torch.float32, device=avg.device)
    dec = ((amp > thresh).to(torch.int8) - (amp < thresh).to(torch.int8)).tolist()
    n = len(dec)
    trig = [False] * n
    pulses_out = [0] * n
    state, n_samp, pulses, open_rem, next_epc = -1, 0, 0, 0, False
    for i, d in enumerate(dec):
        if open_rem:
            open_rem -= 1
            pulses_out[i] = pulses
            continue
        n_samp += 1
        if d > 0 and state == -1:
            pulses = pulses + 1 if n_samp > pw_half else 0
            n_samp, state = 0, 1
        elif d < 0 and state == 1:
            n_samp, state = 0, -1
        pulses_out[i] = pulses
        if n_samp > nt1 and state == 1 and pulses > npc:
            trig[i] = True
            pulses = n_samp = 0
            open_rem = (epc_window if next_epc else rn16_window) - 1
            next_epc = not next_epc
    dev = amp.device
    return (torch.tensor(trig, dtype=torch.bool, device=dev),
            torch.tensor(pulses_out, dtype=torch.int32, device=dev))


# ---- the Python model of the kernel's three phases ------------------------

GROUP = 1024                 # samples per warp of the edge phase
_INF = 2**31 - 1             # past the last edge


def _words(bits: np.ndarray) -> np.ndarray:
    """(n,) bool -> uint32 mask words padded to whole groups: bit b of word w
    is sample 32 w + b."""
    padded = np.zeros(-(-bits.shape[0] // GROUP) * GROUP, bool)
    padded[: bits.shape[0]] = bits
    return np.packbits(padded, bitorder="little").view("<u4")


def _word_edges(hi: np.ndarray, lo: np.ndarray, inc_pos: np.ndarray):
    """Edges of the free-running state (no window ever opens) in each word,
    given the state coming in: (edge mask, state after each sample).  A
    decisive sample (hi or lo) sets the state; a tie keeps it; an edge is a
    decisive sample that changes it.  The fill is the kernel's: five
    doubling steps carry each decisive sample's state up to the next one."""
    d = hi | lo
    state = hi.copy()
    known = d.copy()
    seed = inc_pos.astype(np.uint32)
    for s in (1, 2, 4, 8, 16):
        low = np.uint32((1 << s) - 1)
        state = state | (((state << np.uint32(s)) | (seed * low)) & ~known)
        known = known | (known << np.uint32(s)) | low
    before = (state << np.uint32(1)) | seed
    return d & (hi ^ before), state


def _edge_list(hi: np.ndarray, lo: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Phase 1: positions of the free-running state's edges (a rise first,
    then alternating) and each group's first index in that list.  The
    kernel gets each word's incoming state from the last decisive sample
    before it (a warp ballot within a group, one warp's scan across
    groups); here a running maximum finds the same word."""
    nonzero = (hi | lo) != 0
    _, state0 = _word_edges(hi, lo, np.zeros(hi.shape, bool))
    last_pos = (state0 >> np.uint32(31)).astype(bool)      # where nonzero
    idx = np.where(nonzero, np.arange(hi.size), -1)
    prev = np.maximum.accumulate(np.concatenate([[-1], idx[:-1]]))
    inc_pos = np.where(prev >= 0, last_pos[np.maximum(prev, 0)], False)
    edges_w, _ = _word_edges(hi, lo, inc_pos)
    bits = np.unpackbits(edges_w.view(np.uint8), bitorder="little")
    edges = np.flatnonzero(bits)
    offsets = np.searchsorted(edges, np.arange(hi.size // 32 + 1) * GROUP)
    return edges, offsets


def _find_lo(lo: np.ndarray, p: int, lim: int) -> int:
    """First below-threshold sample in [p, lim), else lim."""
    for w in range(p >> 5, -(-lim // 32)):
        bits = int(lo[w]) & ((0xFFFFFFFF << (p & 31)) & 0xFFFFFFFF if w == p >> 5 else 0xFFFFFFFF)
        if bits:
            return min(w * 32 + ((bits & -bits).bit_length() - 1), lim)
    return lim


def _walk(edges: np.ndarray, offsets: np.ndarray, lo: np.ndarray, n: int,
          pw_half: int, nt1: int, npc: int, rn16_window: int,
          epc_window: int) -> Tuple[List[int], List[int], int]:
    """Phase 2: the FSM over the edge list, 32 edges (16 rises) a step as
    the kernel's walker warp takes them.  Between two windows the FSM's
    edges are the list's.  After a trigger at t the walk resumes at the
    first list edge at or after t + W, in state POS: a fall there is the
    FSM's next edge; a rise there means the samples from t + W on are below
    or tied, so the FSM falls at the first below (if any before the rise)
    and takes the rise, or else ignores the rise and takes the fall after
    it.  Returns the change points of pulses_out, (position, value) in
    increasing position, where value -1 marks a trigger at position - 1
    (pulses_out is 0 from there on), and the number of steps (batches and
    resumptions after a trigger)."""
    m = edges.size

    def edge(k):
        return int(edges[k]) if k < m else _INF

    pos: List[int] = []
    val: List[int] = []
    k, e_prev, pulses, next_epc, steps = 0, -1, 0, False, 0
    while k < m:
        steps += 1
        trig_at = None
        for lane in range(0, 32, 2):            # the batch's rises
            if k + lane >= m:
                break
            r = edge(k + lane)
            prev = e_prev if lane == 0 else edge(k + lane - 1)
            pulses = pulses + 1 if r - prev > pw_half else 0
            pos.append(r)
            val.append(pulses)
            t = r + nt1 + 1
            if pulses > npc and t <= n - 1 and edge(k + lane + 1) > t:
                trig_at = t
                break
        if trig_at is None:
            e_prev = edge(k + 31)
            k += 32
            continue
        steps += 1
        pos.append(trig_at + 1)
        val.append(-1)
        resume = trig_at + (epc_window if next_epc else rn16_window)
        next_epc = not next_epc
        pulses = 0
        if resume >= n:
            break
        kp = max(k + lane + 1, int(offsets[resume // GROUP]))
        while edge(kp) < resume:
            kp += 1
        if kp >= m:
            break
        if kp % 2:                               # a fall: the FSM's next edge
            e_prev, k = edge(kp), kp + 1
            continue
        f = _find_lo(lo, resume, edge(kp))
        if f < edge(kp):                          # falls first, then the rise
            e_prev, k = f, kp
        elif kp + 1 < m:                          # ignores the rise
            e_prev, k = edge(kp + 1), kp + 2
        else:
            break
    return pos, val, steps


def _fill(pos: List[int], val: List[int], n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Phase 3: (trig, pulses_out) of every sample from the change points."""
    # A sentinel change past the end: every sample has a next change.
    cpos = np.asarray(pos + [n + 1], np.int64)
    cval = np.asarray(val + [0], np.int64)
    i = np.arange(n)
    c = np.searchsorted(cpos, i, side="right") - 1      # last change <= i, or -1
    pulses = np.where(c >= 0, np.maximum(cval[c], 0), 0)
    trig = (cpos[c + 1] == i + 1) & (cval[c + 1] < 0)
    return trig, pulses.astype(np.int32)


def gate_scan_edges_plain(amp: torch.Tensor, avg: torch.Tensor, frac: float,
                          pw_half: int, nt1: int, npc: int, rn16_window: int,
                          epc_window: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Python model of the kernel: (trig (n,) bool, pulses_out (n,) int32,
    serial steps of the walk).  Same outputs as ``gate_scan_plain``."""
    _check_args(nt1, npc, rn16_window, epc_window)
    a = amp.detach().cpu().to(torch.float32)
    th = avg.detach().cpu().to(torch.float32) * torch.tensor(frac, dtype=torch.float32)
    hi = _words((a > th).numpy())
    lo = _words((a < th).numpy())
    n = a.shape[0]
    edges, offsets = _edge_list(hi, lo)
    pos, val, steps = _walk(edges, offsets, lo, n, pw_half, nt1, npc, rn16_window,
                            epc_window)
    trig, pulses = _fill(pos, val, n)
    return torch.from_numpy(trig), torch.from_numpy(pulses), steps


def _check_args(nt1: int, npc: int, rn16_window: int, epc_window: int) -> None:
    """The edge walk's rules need a trigger to follow its rise (nt1 >= 0),
    a trigger to need a pulse (npc >= 0) and windows of a sample or more."""
    if nt1 < 0 or npc < 0 or rn16_window < 1 or epc_window < 1:
        raise ValueError(f"gate_scan needs nt1 >= 0, npc >= 0 and windows >= 1, got "
                         f"nt1={nt1} npc={npc} windows {rn16_window}/{epc_window}")


def pulse_train(n: int, pw_half: int, nt1: int, npc: int, rn16_window: int,
                epc_window: int, seed: int = 0, frac: float = 0.5):
    """A synthetic FSM input whose triggers are known: (amp, avg, targets).

    Reader commands of npc+1 low pulses (each longer than pw_half) on a high
    carrier, each placed so that its trigger, nt1+1 samples after its last
    rise, lands on a chosen target once the previous trigger's window has
    closed.  Targets step by random gaps, and are snapped to the last sample
    of a 32-sample word or of a 4096-sample chunk and to the capture's last
    sample, so triggers and open windows straddle both edges.  Samples
    inside a run (not at an edge) are set equal to their threshold now and
    then: a tie keeps the state.  The gate-scan FSM triggers exactly at
    ``targets``, each with npc+1 pulses."""
    rng = np.random.default_rng(seed)
    lo, hi = pw_half + 2, pw_half + 1
    cmd = (npc + 1) * (lo + hi) + nt1 + 1          # first fall .. trigger
    avg = rng.uniform(1.8, 2.2, n).astype(np.float32)
    thresh = avg * np.float32(frac)
    amp = thresh * rng.uniform(1.2, 1.5, n).astype(np.float32)       # high
    targets = []
    t = cmd + 3                # the earliest target
    room = max(rn16_window, epc_window) + cmd + 1
    while t < n:
        targets.append(t)
        rise = t - nt1 - 1
        for p in range(npc + 1):
            r = rise - p * (lo + hi)
            amp[r - lo: r] = thresh[r - lo: r] * rng.uniform(0.0, 0.8, lo).astype(np.float32)
        window = epc_window if len(targets) % 2 == 0 else rn16_window
        if t == n - 1 or t + window + cmd + 1 > n - 1:
            break
        t += window + cmd + int(rng.integers(1, 40))
        choice = int(rng.integers(0, 4))
        if choice == 1:
            t |= 31
        elif choice == 2:
            t |= 4095
        if t + room > n - 1:   # no room for another command after t: end on the last sample
            t = n - 1
    level = np.sign(amp - thresh)
    inner = np.zeros(n, bool)
    inner[1:] = level[1:] == level[:-1]
    tie = inner & (rng.random(n) < 0.05)
    tie[targets] = False
    amp[tie] = thresh[tie]
    return torch.from_numpy(amp), torch.from_numpy(avg), targets


def dense_edges(n: int, seed: int = 0, frac: float = 0.75):
    """(amp, avg) whose decisions flip about every other sample: |noise|
    against a threshold at its median, the FSM's worst case (one walk step
    per edge), with a few exact ties."""
    rng = np.random.default_rng(seed)
    amp = np.abs(rng.normal(size=n)).astype(np.float32)
    avg = np.full(n, np.float32(0.6745 / frac), np.float32)
    tie = rng.random(n) < 0.01
    amp[tie] = avg[tie] * np.float32(frac)
    return torch.from_numpy(amp), torch.from_numpy(avg)


def random_runs(seed: int):
    """(amp, avg, args): runs of above, below and tied samples (1 to 11 long)
    against a threshold of 0.5, with short windows and small pw_half, nt1
    and npc drawn from the seed, so the FSM triggers often and resumes after
    windows that end in every state."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 6000))
    levels = rng.choice([1.0, 0.0, 0.5], p=[0.45, 0.35, 0.2], size=n)
    amp = np.repeat(levels, rng.integers(1, 12, size=n))[:n].astype(np.float32)
    args = (0.5, int(rng.integers(0, 4)), int(rng.integers(0, 6)), int(rng.integers(0, 3)),
            int(rng.integers(1, 40)), int(rng.integers(1, 40)))
    return torch.from_numpy(amp), torch.ones(n), args


LIB = Library("gate_scan", {
    "gate_scan_launch": (I32, (PTR, PTR, I64, F32, I32, I32, I32, I32, I32, PTR, PTR, PTR,
                               PTR)),
    "gate_scan_scratch_words": (I64, (I64,)),
})


def gate_scan(amp: torch.Tensor, avg: torch.Tensor, frac: float, pw_half: int,
              nt1: int, npc: int, rn16_window: int, epc_window: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) float32 |y| and windowed average -> (trig (n,) bool,
    pulses_out (n,) int32)."""
    if amp.dim() != 1 or avg.shape != amp.shape:
        raise ValueError(f"gate_scan takes two (n,) tensors, got "
                         f"{tuple(amp.shape)} and {tuple(avg.shape)}")
    if amp.device.type == "cpu" and avg.device.type == "cpu":
        return gate_scan_plain(amp.to(torch.float32), avg.to(torch.float32), frac,
                               pw_half, nt1, npc, rn16_window, epc_window)
    if amp.device.type != "cuda" or avg.device != amp.device:
        raise ValueError(f"gate_scan runs on cuda or cpu, not {amp.device} / {avg.device}")
    if amp.dtype != torch.float32 or avg.dtype != torch.float32:
        raise ValueError("gate_scan takes float32 tensors")
    _check_args(nt1, npc, rn16_window, epc_window)
    amp, avg = amp.contiguous(), avg.contiguous()
    n = amp.shape[0]
    if n + nt1 + rn16_window + epc_window + 2048 >= 2**31 - 1:
        raise ValueError(f"gate_scan walks int32 positions; n={n} is too long")
    trig = torch.empty((n,), dtype=torch.uint8, device=amp.device)
    pulses_out = torch.empty((n,), dtype=torch.int32, device=amp.device)
    if n == 0:
        return trig.bool(), pulses_out
    scratch = torch.empty((LIB.gate_scan_scratch_words(n),), dtype=torch.int32,
                          device=amp.device)
    launch("gate_scan", LIB.gate_scan_launch, amp.device, amp.data_ptr(), avg.data_ptr(), n,
           frac, pw_half, nt1, npc, rn16_window, epc_window, trig.data_ptr(),
           pulses_out.data_ptr(), scratch.data_ptr())
    return trig.bool(), pulses_out


def gate_scan_for_cfg(amp: torch.Tensor, avg: torch.Tensor, cfg: ReaderConfig):
    return gate_scan(amp, avg, cfg.thresh_fraction, cfg.n_samples_pw // 2,
                     cfg.n_samples_t1, cfg.num_pulses_command, cfg.rn16_window,
                     cfg.epc_window)
