"""Device time of a function on the card, by CUDA events."""

from __future__ import annotations


def cuda_ms(fn, reps, flush=None, warmup=2, sleep_cycles=2_000_000):
    """Median device time of fn() over reps runs, each bracketed by CUDA
    events, after ``warmup`` untimed runs.  ``flush`` (a large buffer) is
    overwritten before each run so the run starts with a cold L2; a spin
    kernel then holds the stream until the host has queued the run, so host
    launch time does not pad the reading of a function that never waits for
    the device (a decode does wait: its reading is its wall time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
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
