"""Front kernels: ``gate_stack``'s share of its roofline (its stream kernel
at ReaderConfig()'s widths, its segment kernel at every other), its least
time at the cell's shape (``roofline.stack_bound``) over its mean device
time a launch in the traced stretch."""

from .. import roofline


def read(trace):
    times = trace.kernel_seconds("stream_kernel") + trace.kernel_seconds("segment_kernel")
    if not times:
        return None
    s = trace.shapes
    least = roofline.stack_bound(s["ny"], s["win"]).seconds
    return 100.0 * least / (sum(times) / len(times))
