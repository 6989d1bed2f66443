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
"""

from __future__ import annotations

import ctypes

import torch

from . import launches
from ..config import ReaderConfig
from ..dsp.filters import magnitude, run_sum

RISE, QUALIFY, MARKER, QUIET = 1, 2, 4, 8


def gate_stack_plain(y2: torch.Tensor, win: int, pw_half: int, nt1: int,
                     frac: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (2, Ny) -> (Ny,) int32 flags."""
    n = y2.shape[1]
    dev = y2.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    arange = torch.arange(n, dtype=torch.int32, device=dev)
    amp = magnitude(y2[0], y2[1])
    msum = run_sum(amp, win)
    # A tensor divisor keeps the division IEEE on CUDA too (PyTorch turns
    # division by a Python scalar into a reciprocal multiply there).
    avg = msum / torch.tensor(float(win), dtype=torch.float32, device=dev)
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


def _launcher():
    from ._build import library

    fn = library("gate_stack").gate_stack_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def gate_stack_flags(y2: torch.Tensor, win: int, pw_half: int, nt1: int,
                     frac: float, block: int = 1024) -> torch.Tensor:
    """(2, Ny) float32 planar I/Q -> (Ny,) int32 packed flags.  ``block``:
    outputs per CUDA block."""
    if y2.dim() != 2 or y2.shape[0] != 2:
        raise ValueError(f"gate_stack takes (2, Ny) planar I/Q, got {tuple(y2.shape)}")
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
    launch = _launcher()
    with torch.cuda.device(y2.device):
        stream = torch.cuda.current_stream(y2.device).cuda_stream
        err = launch(y2.data_ptr(), ny, win, pw_half, nt1, frac, block,
                     flags.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gate_stack kernel launch failed: CUDA error {err}")
    launches["gate_stack"] += 1
    return flags


def gate_stack_for_cfg(y2: torch.Tensor, cfg: ReaderConfig, **kw) -> torch.Tensor:
    return gate_stack_flags(y2, cfg.win_length, cfg.n_samples_pw // 2,
                            cfg.n_samples_t1, cfg.thresh_fraction, **kw)
