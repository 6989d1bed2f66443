"""The yardstick of the kernels' roofline shares: the card's peaks and the
bytes and operations each kernel needs at a shape.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.  A
kernel's least time is the larger of its bytes over the first and its
float operations over the second, each input byte counted once as read and
each output byte once as written.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


class Bound(NamedTuple):
    seconds: float
    by: str          # "bytes" or "operations"


def bound(bytes_moved: float, flops: float) -> Bound:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return Bound(t_bytes, "bytes") if t_bytes >= t_ops else Bound(t_ops, "operations")


def front_y_bound(n: int, ny: int, taps: int) -> Bound:
    """``gate_front_y_kernel``: planar (2, N) float32 in, y (2, Ny) float32
    out; 2T adds an output (T taps, each plane)."""
    return bound(4 * (2 * n) + 4 * (2 * ny), ny * 2 * taps)


def stack_bound(ny: int, win: int) -> Bound:
    """``gate_stack``'s stream or segment kernel: (2, Ny) float32 in, Ny int32
    flags out; a sample's |y| (3), the average's dyadic levels and their
    combine over ``win``, its scaling (1) and the threshold compare (2)."""
    return bound(4 * (2 * ny) + 4 * ny,
                 ny * (3 + 1 + (win.bit_length() - 1) + (bin(win).count("1") - 1) + 2))
