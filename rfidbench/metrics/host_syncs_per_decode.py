"""Entry and dispatch: the host syncs a decode, each a span of the port's
recorder: ``gen2.host_read`` (a device value read on the host) and
``gen2.host_copy`` (a blocking copy of a host array to the card), each of
which waits for the device's stream."""

from ._spans import HOST_SYNCS, per_decode


def read(trace):
    return per_decode(trace, HOST_SYNCS, None)
