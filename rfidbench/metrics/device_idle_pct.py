"""Device (H100): the share of the traced stretch in which no kernel, copy
or fill ran on the card, 100 minus the union of their intervals over the
stretch's wall."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
