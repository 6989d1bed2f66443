"""Device time of a function on the card, by CUDA events."""

from __future__ import annotations

FLUSHES = ("write", "read")


def cuda_ms(fn, reps, flush=None, warmup=2, sleep_cycles=2_000_000, flush_by="write"):
    """Median device time of fn() over reps runs, each bracketed by CUDA
    events, after ``warmup`` untimed runs.  ``flush`` (a buffer larger than
    L2) is gone over before each run so the run starts with none of its data
    in L2: ``flush_by="write"`` overwrites it, which leaves L2 full of dirty
    lines that the run's own traffic must write back; ``"read"`` sums it,
    which leaves L2 clean.  A spin kernel then holds the stream until the
    host has queued the run, so host launch time does not pad the reading of
    a function that never waits for the device (a decode does wait: its
    reading is its wall time)."""
    import torch

    if flush_by not in FLUSHES:
        raise ValueError(f"flush_by is one of {FLUSHES}, not {flush_by!r}")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            if flush_by == "write":
                flush.zero_()
            else:
                flush.sum()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]
