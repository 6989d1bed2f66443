"""Gate: the device ms a decode of the ``gen2.gate`` span
(``dsp/gate.py::gate_detect``), event to event on the device's clock."""

from ._spans import per_decode


def read(trace):
    return per_decode(trace, ("gen2.gate",), "device_ms")
