"""Entry and dispatch: the device operations (kernels, copies, fills) that
one call of ``decode_capture_planar`` puts on the card, over the traced
stretch's decodes."""


def read(trace):
    if not trace.device or trace.decodes <= 0:
        return None
    return len(trace.device) / trace.decodes
