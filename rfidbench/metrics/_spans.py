"""What the span readers share: the port's span recorder
(``gen2_rfid_tpu_torch/utils/profiling.py``) read over the traced stretch.

The profiler turns the recorder on, so the stretch's decodes are its
latest session, and the warm-up decodes before it, run with the recorder
off, are not.  A reader finds nothing (None) where the stretch put no
operation on a device, where the program has no recorder, or where the
session does not hold one root span a traced decode or dropped any span.
"""

ROOT = "gen2.decode_capture"
HOST_SYNCS = ("gen2.host_read", "gen2.host_copy")


def session(trace):
    """The session's spans (``profiling.spans()``), or None."""
    if not trace.device or trace.decodes <= 0:
        return None
    try:
        from gen2_rfid_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans, dropped = getattr(profiling, "spans", None), getattr(profiling, "dropped", None)
    if spans is None or dropped is None or dropped():
        return None
    rows = spans()
    tops = [r for r in rows if r["parent"] is None]
    if len(tops) != trace.decodes or any(r["name"] != ROOT for r in tops):
        return None
    return rows


def per_decode(trace, names, field):
    """The sum of ``field`` over the session's spans named in ``names``,
    over the stretch's decodes; ``field`` None counts the spans."""
    rows = session(trace)
    if rows is None:
        return None
    picked = [r for r in rows if r["name"] in names]
    total = len(picked) if field is None else sum(r[field] for r in picked)
    return total / trace.decodes
