"""Entry and dispatch: the host ms a decode spent inside its syncs
(``gen2.host_read`` and ``gen2.host_copy`` spans), waiting for the device;
the rest of the root span's host time is the host's dispatch."""

from ._spans import HOST_SYNCS, per_decode


def read(trace):
    return per_decode(trace, HOST_SYNCS, "host_ms")
