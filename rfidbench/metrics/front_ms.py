"""Front kernels: the device ms a decode of the ``gen2.front`` span (the
capture's move to the card, ``gate_front_y``, the complex pack, the gate
stack), event to event on the device's clock."""

from ._spans import per_decode


def read(trace):
    return per_decode(trace, ("gen2.front",), "device_ms")
