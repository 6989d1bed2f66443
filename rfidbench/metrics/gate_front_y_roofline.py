"""Front kernels: ``gate_front_y_kernel``'s share of its roofline, its least
time at the cell's shape (``roofline.front_y_bound``) over its mean device
time a launch in the traced stretch."""

from .. import roofline


def read(trace):
    times = trace.kernel_seconds("gate_front_y_kernel")
    if not times:
        return None
    s = trace.shapes
    least = roofline.front_y_bound(s["n"], s["ny"], s["taps"]).seconds
    return 100.0 * least / (sum(times) / len(times))
