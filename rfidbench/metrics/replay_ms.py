"""Replay: the device ms a decode of the ``gen2.replay`` span
(``runtime/inventory.py::replay_inventory``), event to event on the
device's clock."""

from ._spans import per_decode


def read(trace):
    return per_decode(trace, ("gen2.replay",), "device_ms")
