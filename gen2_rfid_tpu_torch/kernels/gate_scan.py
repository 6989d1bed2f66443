"""The reference gate's per-sample state machine, walked in order.

Counterpart of the ``lax.scan`` in ``gen2_rfid_tpu/dsp/gate.py::
gate_detect_scan`` (:341-366), the exact sequential oracle behind
``exact_gate=True``.  From |y|, its windowed average and the threshold
fraction it gives, per sample, whether the gate triggered there and the
pulse count the FSM held (dsp/gate.py::gate_detect_scan builds the event
table from them).

On a CUDA tensor the wrapper launches ``csrc/gate_scan.cu`` (one thread
walks the capture); on a CPU tensor it runs ``gate_scan_plain``, a Python
loop over the same decisions.  Both compare ``amp`` with the float32 product
``avg * frac``, so they give equal outputs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import launches
from ..config import ReaderConfig


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


def pulse_train(n: int, pw_half: int, nt1: int, npc: int, rn16_window: int,
                epc_window: int, seed: int = 0, frac: float = 0.5):
    """A synthetic FSM input whose triggers are known: (amp, avg, targets).

    Reader commands of npc+1 low pulses (each longer than pw_half) on a high
    carrier, each placed so that its trigger, nt1+1 samples after its last
    rise, lands on a chosen target once the previous trigger's window has
    closed.  Targets step by random gaps, and are snapped to the last sample
    of a 32-sample word or of a 4096-sample chunk (the kernel's units) and
    to the capture's last sample, so triggers and open windows straddle
    both edges.  Samples inside a run (not at an edge) are set equal to
    their threshold now and then: a tie keeps the state.  The gate-scan FSM
    triggers exactly at ``targets``, each with npc+1 pulses."""
    import numpy as np

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


def _launcher():
    from ._build import library

    fn = library("gate_scan").gate_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


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
    amp, avg = amp.contiguous(), avg.contiguous()
    n = amp.shape[0]
    trig = torch.empty((n,), dtype=torch.uint8, device=amp.device)
    pulses_out = torch.empty((n,), dtype=torch.int32, device=amp.device)
    if n == 0:
        return trig.bool(), pulses_out
    launch = _launcher()
    with torch.cuda.device(amp.device):
        stream = torch.cuda.current_stream(amp.device).cuda_stream
        err = launch(amp.data_ptr(), avg.data_ptr(), n, frac, pw_half, nt1, npc,
                     rn16_window, epc_window, trig.data_ptr(),
                     pulses_out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gate_scan kernel launch failed: CUDA error {err}")
    launches["gate_scan"] += 1
    return trig.bool(), pulses_out


def gate_scan_for_cfg(amp: torch.Tensor, avg: torch.Tensor, cfg: ReaderConfig):
    return gate_scan(amp, avg, cfg.thresh_fraction, cfg.n_samples_pw // 2,
                     cfg.n_samples_t1, cfg.num_pulses_command, cfg.rn16_window,
                     cfg.epc_window)
