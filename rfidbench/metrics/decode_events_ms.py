"""Decode: the device ms a decode of the ``gen2.decode_events`` span
(``runtime/inventory.py::decode_events``), event to event on the device's
clock."""

from ._spans import per_decode


def read(trace):
    return per_decode(trace, ("gen2.decode_events",), "device_ms")
