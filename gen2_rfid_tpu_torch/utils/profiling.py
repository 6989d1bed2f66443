"""Profiling / timing harness (tracing subsystem).

PyTorch counterpart of ``gen2_rfid_tpu/utils/profiling.py``: a
``torch.profiler`` trace around any block, steady-state timing with the
first calls (kernel builds, warm-up) counted apart, and per-stage
throughput counters.  Work on the card is asynchronous, so every time here
ends with ``torch.cuda.synchronize()`` once CUDA is in use, where the JAX
module waits with ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class TimingResult:
    compile_s: float
    mean_s: float
    best_s: float
    iters: int

    def throughput(self, items: float) -> float:
        return items / self.mean_s


def time_jitted(fn: Callable[..., Any], *args, iters: int = 5,
                warmup: int = 1) -> TimingResult:
    """Time a callable: the first call(s) build the kernels and warm up
    (``compile_s``), then the steady state, each call synchronized."""
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync()
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return TimingResult(
        compile_s=compile_s,
        mean_s=sum(times) / len(times),
        best_s=min(times),
        iters=iters,
    )


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Capture a ``torch.profiler`` trace of the block, host and (where
    CUDA is available) device activity, written for TensorBoard's profiler
    plugin to ``log_dir`` (default ``build/gen2_rfid_tpu_torch/trace`` beside
    the package)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        from ..kernels._build import BUILD_DIR

        log_dir = str(BUILD_DIR / "trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        _sync()


class StageCounters:
    """Samples/s and events/s accounting across pipeline stages."""

    def __init__(self):
        self._acc: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            s = self._acc.setdefault(name, {"time_s": 0.0, "items": 0.0, "calls": 0})
            s["time_s"] += dt
            s["items"] += items
            s["calls"] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._acc.items():
            out[name] = dict(s)
            if s["time_s"] > 0 and s["items"]:
                out[name]["items_per_s"] = s["items"] / s["time_s"]
        return out
