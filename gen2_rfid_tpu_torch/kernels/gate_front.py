"""Fused gate front end: boxcar FIR + decimation, |y|, and two windowed sums.

Port of the Pallas TPU kernel ``gen2_rfid_tpu/kernels/gate_front.py``.  One
pass over planar (2, N) float32 ADC-rate I/Q gives, per post-decimation
sample k < Ny = N // decim:

    y[k]      = sum_{j<T} x[k*decim - (T-1) + j]   (boxcar, zero history)
    amp[k]    = |y[k]|
    avgsum[k] = sum_{w<W} amp[k-w]                 (W = win_length)
    dcsum[k]  = sum_{w<D} y[k-w]                   (D = dc_length)

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/gate_front.cu`` (one wave of blocks walks tiles of ``block_y``
outputs, loading the next tile's slab while it sums this one; each thread
sums 4 consecutive outputs from a register window); on a CPU tensor it
runs ``gate_front_plain``, which sums in the same order (taps j = 0..T-1;
windows k, k-1, ..., k-w+1), so the two agree bit for bit.  The kernel
sums the taps without multiplying by them: it is boxcar-only, like the
Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import keep, launches
from ..config import ReaderConfig
from ..dsp.filters import magnitude


def _windowed(v: torch.Tensor, w: int) -> torch.Tensor:
    """v[..., k] + v[..., k-1] + ... + v[..., k-w+1], zero history."""
    ny = v.shape[-1]
    vp = torch.cat([v.new_zeros(v.shape[:-1] + (w - 1,)), v], dim=-1)
    out = vp[..., w - 1: w - 1 + ny]
    for s in range(1, w):
        out = out + vp[..., w - 1 - s: w - 1 - s + ny]
    return out


def gate_front_plain(x2: torch.Tensor, decim: int, n_taps: int, win: int,
                     dcw: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel, in the kernel's summation order."""
    n = x2.shape[1]
    ny = n // decim
    xp = torch.cat([x2.new_zeros((2, n_taps - 1)), x2], dim=1)
    y2 = x2.new_zeros((2, ny))
    for j in range(n_taps):
        y2 = y2 + xp[:, j: j + ny * decim: decim]
    amp = magnitude(y2[0], y2[1])
    return y2, amp, _windowed(amp, win), _windowed(y2, dcw)


# Outputs per tile, chosen on the H100 by chip_smoke.py's sweep (PERF.md).
# At 924 a tile's y groups (4 outputs each) fill one pass of a block's 256
# threads.
BLOCK_Y = 924
SMEM_LIMIT = 232448          # bytes of shared memory a block may take on Hopper


def _lib():
    from ._build import library

    lib = library("gate_front")
    lib.gate_front_launch.restype = ctypes.c_int
    lib.gate_front_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gate_front_smem_bytes.restype = ctypes.c_longlong
    lib.gate_front_smem_bytes.argtypes = [ctypes.c_int] * 5
    return lib


@functools.lru_cache(maxsize=None)
def fitting_block_y(decim: int, n_taps: int, win: int, dcw: int) -> int:
    """The largest tile up to ``BLOCK_Y`` (a multiple of 4) whose slab and
    halo the kernel takes: a halo of max(W, D)-1 y needs more passes of a
    block's threads and more shared memory as the sample rate grows."""
    lib = _lib()
    for block_y in range(BLOCK_Y, 0, -4):
        if 0 <= lib.gate_front_smem_bytes(decim, n_taps, win, dcw, block_y) <= SMEM_LIMIT:
            return block_y
    raise ValueError(f"gate_front: no tile fits widths decim={decim}, taps={n_taps}, "
                     f"W={win}, D={dcw}")


def gate_front(x2: torch.Tensor, decim: int, n_taps: int, win: int, dcw: int,
               block_y: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """(2, N) float32 planar I/Q -> (y2 (2, Ny), amp (Ny), avgsum (Ny),
    dcsum2 (2, Ny)), all float32.  ``block_y``: outputs per tile (what a
    CUDA block sums at a time), a multiple of 4; None takes
    ``fitting_block_y`` (``BLOCK_Y`` wherever it fits)."""
    if x2.dim() != 2 or x2.shape[0] != 2:
        raise ValueError(f"gate_front takes (2, N) planar I/Q, got {tuple(x2.shape)}")
    if x2.device.type == "cpu":
        return gate_front_plain(x2.to(torch.float32), decim, n_taps, win, dcw)
    if x2.device.type != "cuda":
        raise ValueError(f"gate_front runs on cuda or cpu, not {x2.device}")
    if x2.dtype != torch.float32 or not x2.is_contiguous():
        raise ValueError("gate_front takes a contiguous float32 tensor")
    if block_y is None:
        block_y = fitting_block_y(decim, n_taps, win, dcw)
    if block_y < 1 or block_y % 4:
        raise ValueError(f"gate_front: block_y={block_y} must be a positive multiple of 4")
    n = x2.shape[1]
    ny = n // decim
    y2 = torch.empty((2, ny), dtype=torch.float32, device=x2.device)
    amp = torch.empty((ny,), dtype=torch.float32, device=x2.device)
    avgsum = torch.empty_like(amp)
    dcsum2 = torch.empty_like(y2)
    if ny == 0:
        return y2, amp, avgsum, dcsum2
    lib = _lib()
    smem = lib.gate_front_smem_bytes(decim, n_taps, win, dcw, block_y)
    if smem < 0:
        raise ValueError(f"gate_front: block_y={block_y} is too large: a thread keeps "
                         f"at most 6 groups of 4 y")
    if smem > SMEM_LIMIT:
        raise ValueError(f"gate_front: block_y={block_y} is too large: it needs {smem} "
                         f"bytes of shared memory a block, over the card's {SMEM_LIMIT}")
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.gate_front_launch(x2.data_ptr(), n, decim, n_taps, win, dcw, block_y,
                                    y2.data_ptr(), amp.data_ptr(), avgsum.data_ptr(),
                                    dcsum2.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gate_front kernel launch failed: CUDA error {err}")
    launches["gate_front"] += 1
    keep("gate_front", x2, (decim, n_taps, win, dcw, block_y))
    return y2, amp, avgsum, dcsum2


def front_taps(cfg: ReaderConfig) -> int:
    """Boxcar length matched to half an FM0 symbol or one Miller half-cycle
    at ADC rate (25 at the defaults); runtime/inventory.py::matched_taps is
    this many ones."""
    return int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)


def gate_front_for_cfg(x2: torch.Tensor, cfg: ReaderConfig, **kw):
    return gate_front(x2, cfg.decim, front_taps(cfg), cfg.win_length,
                      cfg.dc_length, **kw)
