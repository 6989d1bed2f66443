"""Gate front end: boxcar FIR + decimation alone, or fused with |y| and two
windowed sums.

Port of the Pallas TPU kernel ``gen2_rfid_tpu/kernels/gate_front.py``.  Per
post-decimation sample k < Ny = N // decim of planar (2, N) float32
ADC-rate I/Q:

    y[k]      = sum_{j<T} x[k*decim - (T-1) + j]   (boxcar, zero history)
    amp[k]    = |y[k]|
    avgsum[k] = sum_{w<W} amp[k-w]                 (W = win_length)
    dcsum[k]  = sum_{w<D} y[k-w]                   (D = dc_length)

Two builds of the hand-written kernel ``csrc/gate_front.cu``:

* ``gate_front_y``: y alone, what every path that reads only y takes (every
  native decode, MRC, recovery, the live reader's native windows, stream
  chunks, native shards): the JAX package's default path computes y alone
  there too (``dsp/filters.py::matched_filter_decimate``).  One wave of
  blocks walks tiles of ``block_y`` outputs whose slabs hold the taps' span
  and no more; each thread sums 8 consecutive y from one walk of their span.
* ``gate_front``: all four, for compat mode and the exact gate, which read
  |y| and the windowed average (one wave of blocks walks tiles of
  ``block_y`` outputs plus the windows' halo, loading the next tile's slab
  while it sums this one; each thread sums 4 consecutive outputs from a
  register window).

On a CUDA tensor each wrapper launches its build; on a CPU tensor it runs
its plain version (``gate_front_y_plain``, ``gate_front_plain``), which sums
in the same order (taps j = 0..T-1; windows k, k-1, ..., k-w+1), so the two
agree bit for bit, and both builds give the same y.  The kernel sums the
taps without multiplying by them: it is boxcar-only, like the Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import front_bodies, keep
from ..config import ReaderConfig
from ..dsp.filters import magnitude
from ._build import I32, I64, PTR, Library, launch


def _windowed(v: torch.Tensor, w: int) -> torch.Tensor:
    """v[..., k] + v[..., k-1] + ... + v[..., k-w+1], zero history."""
    ny = v.shape[-1]
    vp = torch.cat([v.new_zeros(v.shape[:-1] + (w - 1,)), v], dim=-1)
    out = vp[..., w - 1: w - 1 + ny]
    for s in range(1, w):
        out = out + vp[..., w - 1 - s: w - 1 - s + ny]
    return out


def gate_front_y_plain(x2: torch.Tensor, decim: int, n_taps: int) -> torch.Tensor:
    """Plain PyTorch version of the y build: the taps summed in order."""
    n = x2.shape[1]
    ny = n // decim
    xp = torch.cat([x2.new_zeros((2, n_taps - 1)), x2], dim=1)
    y2 = x2.new_zeros((2, ny))
    for j in range(n_taps):
        y2 = y2 + xp[:, j: j + ny * decim: decim]
    return y2


def gate_front_plain(x2: torch.Tensor, decim: int, n_taps: int, win: int,
                     dcw: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the full build, in the kernel's summation
    order."""
    y2 = gate_front_y_plain(x2, decim, n_taps)
    amp = magnitude(y2[0], y2[1])
    return y2, amp, _windowed(amp, win), _windowed(y2, dcw)


# Outputs per tile of the full build, chosen on the H100 by chip_smoke.py's
# sweep (PERF.md).  At 924 a tile's y groups (4 outputs each) fill one pass
# of a block's 256 threads.
BLOCK_Y = 924
# Outputs per tile of the y build at most, chosen on the H100 by
# chip_smoke.py's sweeps (PERF.md): one group of 8 outputs for each of a
# block's 128 threads.
BLOCK_Y_Y = 1024
Y_GROUP = 8                  # consecutive y a thread of the y build sums
SMEM_LIMIT = 232448          # bytes of shared memory a block may take on Hopper


LIB = Library("gate_front", {
    "gate_front_launch": (I32, (PTR, I64, I32, I32, I32, I32, I32, PTR, PTR, PTR, PTR, PTR)),
    "gate_front_smem_bytes": (I64, (I32,) * 5),
    "gate_front_y_launch": (I32, (PTR, I64, I32, I32, I32, PTR, PTR)),
    "gate_front_y_smem_bytes": (I64, (I32,) * 3),
})


def _check_planar(x2: torch.Tensor, name: str) -> None:
    if x2.dim() != 2 or x2.shape[0] != 2:
        raise ValueError(f"{name} takes (2, N) planar I/Q, got {tuple(x2.shape)}")


@functools.lru_cache(maxsize=None)
def fitting_block_y(decim: int, n_taps: int, win: int, dcw: int) -> int:
    """The largest tile up to ``BLOCK_Y`` (a multiple of 4) whose slab and
    halo the kernel takes: a halo of max(W, D)-1 y needs more passes of a
    block's threads and more shared memory as the sample rate grows."""
    for block_y in range(BLOCK_Y, 0, -4):
        if 0 <= LIB.gate_front_smem_bytes(decim, n_taps, win, dcw, block_y) <= SMEM_LIMIT:
            return block_y
    raise ValueError(f"gate_front: no tile fits widths decim={decim}, taps={n_taps}, "
                     f"W={win}, D={dcw}")


def gate_front(x2: torch.Tensor, decim: int, n_taps: int, win: int, dcw: int,
               block_y: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """(2, N) float32 planar I/Q -> (y2 (2, Ny), amp (Ny), avgsum (Ny),
    dcsum2 (2, Ny)), all float32.  ``block_y``: outputs per tile (what a
    CUDA block sums at a time), a multiple of 4; None takes
    ``fitting_block_y`` (``BLOCK_Y`` wherever it fits)."""
    _check_planar(x2, "gate_front")
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
    smem = LIB.gate_front_smem_bytes(decim, n_taps, win, dcw, block_y)
    if smem < 0:
        raise ValueError(f"gate_front: block_y={block_y} is too large: a thread keeps "
                         f"at most 6 groups of 4 y")
    if smem > SMEM_LIMIT:
        raise ValueError(f"gate_front: block_y={block_y} is too large: it needs {smem} "
                         f"bytes of shared memory a block, over the card's {SMEM_LIMIT}")
    launch("gate_front", LIB.gate_front_launch, x2.device, x2.data_ptr(), n, decim, n_taps,
           win, dcw, block_y, y2.data_ptr(), amp.data_ptr(), avgsum.data_ptr(),
           dcsum2.data_ptr())
    front_bodies["full"] += 1
    keep("gate_front", x2, ("full", decim, n_taps, win, dcw, block_y))
    return y2, amp, avgsum, dcsum2


@functools.lru_cache(maxsize=None)
def _fitting_y_tile(decim: int, n_taps: int) -> int:
    """``BLOCK_Y_Y``, or the largest multiple of 8 below it whose two slabs
    fit a block's shared memory (a slab holds (block_y - 1)*decim + T
    samples a plane, so only a wide decimation or filter shrinks it)."""
    for block_y in range(BLOCK_Y_Y, 0, -Y_GROUP):
        if LIB.gate_front_y_smem_bytes(decim, n_taps, block_y) <= SMEM_LIMIT:
            return block_y
    raise ValueError(f"gate_front_y: no tile fits decim={decim}, taps={n_taps}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def y_block_y(decim: int, n_taps: int, ny: int, device: torch.device) -> int:
    """The y build's tile on ``device``: the fitting tile, cut so that a
    capture of Ny outputs has a tile for every SM where it is short (a live
    window's thousand y would otherwise sit on one or two SMs)."""
    spread = -(-ny // (_sm_count(device) * Y_GROUP)) * Y_GROUP
    return min(_fitting_y_tile(decim, n_taps), max(spread, Y_GROUP))


def gate_front_y(x2: torch.Tensor, decim: int, n_taps: int,
                 block_y: Optional[int] = None) -> torch.Tensor:
    """(2, N) float32 planar I/Q -> y2 (2, Ny) float32, the full build's y
    bit for bit.  ``block_y``: outputs per tile, a multiple of 8; None takes
    ``y_block_y``'s."""
    _check_planar(x2, "gate_front_y")
    if x2.device.type == "cpu":
        return gate_front_y_plain(x2.to(torch.float32), decim, n_taps)
    if x2.device.type != "cuda":
        raise ValueError(f"gate_front_y runs on cuda or cpu, not {x2.device}")
    if x2.dtype != torch.float32 or not x2.is_contiguous():
        raise ValueError("gate_front_y takes a contiguous float32 tensor")
    if decim < 1 or n_taps < 1:
        raise ValueError(f"gate_front_y: decim={decim} and taps={n_taps} must be positive")
    n = x2.shape[1]
    if block_y is None:
        block_y = y_block_y(decim, n_taps, n // decim, x2.device)
    if block_y < Y_GROUP or block_y % Y_GROUP:
        raise ValueError(f"gate_front_y: block_y={block_y} must be a positive multiple of "
                         f"{Y_GROUP}")
    y2 = torch.empty((2, n // decim), dtype=torch.float32, device=x2.device)
    if y2.shape[1] == 0:
        return y2
    smem = LIB.gate_front_y_smem_bytes(decim, n_taps, block_y)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gate_front_y: block_y={block_y} is too large: it needs {smem} "
                         f"bytes of shared memory a block, over the card's {SMEM_LIMIT}")
    launch("gate_front", LIB.gate_front_y_launch, x2.device, x2.data_ptr(), n, decim, n_taps,
           block_y, y2.data_ptr())
    front_bodies["y"] += 1
    keep("gate_front", x2, ("y", decim, n_taps, block_y))
    return y2


def front_taps(cfg: ReaderConfig) -> int:
    """Boxcar length matched to half an FM0 symbol or one Miller half-cycle
    at ADC rate (25 at the defaults); runtime/inventory.py::matched_taps is
    this many ones."""
    return int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)


def gate_front_for_cfg(x2: torch.Tensor, cfg: ReaderConfig, **kw):
    return gate_front(x2, cfg.decim, front_taps(cfg), cfg.win_length,
                      cfg.dc_length, **kw)


def gate_front_y_for_cfg(x2: torch.Tensor, cfg: ReaderConfig, **kw) -> torch.Tensor:
    return gate_front_y(x2, cfg.decim, front_taps(cfg), **kw)
