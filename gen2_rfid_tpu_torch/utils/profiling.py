"""The port's span recorder, and a ``torch.profiler`` trace around any block.

``span(name, **attrs)`` marks one stage of a decode.  The decode path opens
one at each layer boundary: ``gen2.decode_capture`` (the root, in
``runtime/inventory.py::decode_capture_planar``), ``gen2.front``,
``gen2.gate``, ``gen2.decode_events`` and ``gen2.replay``; and one around
each host sync, ``gen2.host_read`` for a read of a device value on the host
(``host_read``) and ``gen2.host_copy`` for a blocking copy of a host array
to the device (``to_device``), which waits for the device's stream as a
read does.

Off, the default, a span checks two switches and returns a shared no-op
context: no ``record_function``, no CUDA event, no clock read.  It is on
while a ``torch.profiler`` session runs and inside ``recording()``.  Then a
span

* enters ``torch.profiler.record_function(name)``, so that it shows in the
  profiler's trace as a ``user_annotation`` on the clock of that trace's
  kernels and runtime calls;
* reads the host clock at entry and exit and, once CUDA is initialised,
  records a timing event at each on the current stream; it never
  synchronizes;
* stores its name, its parent, the decode id its root gave it (a span
  opened outside any other starts a decode of its own), both times and its
  ``attrs``.  ``allocator=<device>`` adds the caching allocator's new
  segments (``cudaMalloc`` calls) and retries between entry and exit.

The recorder keeps the spans of its latest session, up to ``MAX_SPANS``
(later spans are counted by ``dropped()``).  A ``recording()`` or
``trace()`` block entered outside any span is a session; so are the spans
of a profiler run, from the first one recorded after a span found
recording off or after such a block.  (Two profiler runs with no span
between them share one.)  ``spans()`` resolves them, with one
``torch.cuda.synchronize()`` at read time: each span's host ms, its device
ms (event to event; the host's where the span holds no events, as on the
CPU), and its self times, the duration less what its child spans cover.
``span_table()`` sums them by name.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

HOST_READ = "gen2.host_read"
HOST_COPY = "gen2.host_copy"
MAX_SPANS = 1_000_000


class _Off:
    """The shared context of a span while recording is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Session:
    def __init__(self):
        self.records: List[_Span] = []
        self.dropped = 0
        self.decodes = 0


_session = _Session()
_stack: List["_Span"] = []
_forced = 0       # open recording() blocks
_live = False     # the last span found recording on


def _allocator_counts(dev: torch.device) -> Dict[str, int]:
    """The caching allocator's ``segment.all.allocated`` and
    ``num_alloc_retries`` (``torch.cuda.memory_stats``' keys), read from
    the nested statistics: 19 µs a read on an H100, against 99 flat."""
    stats = torch.cuda.memory_stats_as_nested_dict(dev)
    return {"segment_allocs": stats.get("segment", {}).get("all", {}).get("allocated", 0),
            "alloc_retries": stats.get("num_alloc_retries", 0)}


class _Span:
    __slots__ = ("name", "attrs", "allocator", "mem0", "index", "parent", "decode",
                 "t0", "t1", "stream", "e0", "e1", "rf")

    def __init__(self, name: str, allocator, attrs: Dict):
        self.name, self.allocator, self.attrs = name, allocator, attrs
        self.mem0 = self.e0 = self.e1 = self.t1 = None

    def __enter__(self):
        s = _session
        parent = _stack[-1] if _stack else None
        self.parent = parent.index if parent is not None else None
        if parent is not None:
            self.decode = parent.decode
        else:
            self.decode = s.decodes
            s.decodes += 1
        self.index = len(s.records)
        s.records.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.allocator is not None and self.allocator.type == "cuda":
            self.mem0 = _allocator_counts(self.allocator)
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record(self.stream)
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.e0 is not None:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record(self.stream)
        if self.mem0 is not None:
            now = _allocator_counts(self.allocator)
            self.attrs.update({k: now[k] - v for k, v in self.mem0.items()})
        if _stack and _stack[-1] is self:
            _stack.pop()
        self.rf.__exit__(*exc)
        return False


def _new_session() -> None:
    global _session, _live
    _session = _Session()
    _stack.clear()
    _live = True


def span(name: str, allocator: Optional[torch.device] = None, **attrs):
    """A context manager marking one stage; see the module's docstring."""
    global _live
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        _live = False
        return _OFF
    if not _live:
        _new_session()
    if len(_session.records) >= MAX_SPANS:
        _session.dropped += 1
        return _OFF
    return _Span(name, allocator, attrs)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def host_read(t: torch.Tensor):
    """The host's value of ``t`` inside a ``gen2.host_read`` span: the
    Python scalar of a 0-d tensor (as ``int(t)``, ``bool(t)`` or
    ``float(t)`` gives it), else the NumPy array of ``t.cpu()``."""
    with span(HOST_READ):
        if t.dim() == 0:
            return t.item()
        return t.cpu().numpy()


def to_device(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` inside a
    ``gen2.host_copy`` span: a host array or scalar copied to the card
    without pinning waits for the stream as a read does."""
    with span(HOST_COPY):
        return torch.as_tensor(x, dtype=dtype, device=device)


def _new_session_if_idle() -> bool:
    if _stack:
        return False
    _new_session()
    return True


@contextlib.contextmanager
def recording():
    """Record spans inside the block.  Entered outside any span, the block
    is a session of its own; its spans stay readable after it."""
    global _forced, _live
    own = _new_session_if_idle()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1
        if own:
            _live = False


def dropped() -> int:
    """Spans of the latest session past ``MAX_SPANS``, not stored."""
    return _session.dropped


def _union_ms(intervals, lo: float, hi: float) -> float:
    covered, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            covered += b - a
            end = b
    return covered


def spans() -> List[Dict]:
    """The latest session's closed spans, in the order they opened: index,
    name, parent (an index or None), decode, attrs, host_ms, device_ms,
    self_host_ms and self_ms (device).  Offsets (``host_start_ms``,
    ``start_ms``) count from the session's first span."""
    done = [r for r in _session.records if r.t1 is not None]
    if any(r.e1 is not None for r in done):
        torch.cuda.synchronize()
    if not done:
        return []
    t_base = done[0].t0
    e_base = next((r.e0 for r in done if r.e0 is not None), None)
    out, host, dev = [], {}, {}
    for r in done:
        h = ((r.t0 - t_base) / 1e6, (r.t1 - t_base) / 1e6)
        d = ((e_base.elapsed_time(r.e0), e_base.elapsed_time(r.e1))
             if r.e1 is not None else h)
        host[r.index], dev[r.index] = h, d
    children: Dict[int, List[int]] = {}
    for r in done:
        if r.parent in host:
            children.setdefault(r.parent, []).append(r.index)
    for r in done:
        (ha, hb), (da, db) = host[r.index], dev[r.index]
        kids = children.get(r.index, ())
        out.append({
            "index": r.index, "name": r.name, "parent": r.parent, "decode": r.decode,
            "attrs": dict(r.attrs), "host_start_ms": ha, "start_ms": da,
            "host_ms": hb - ha, "device_ms": db - da,
            "self_host_ms": hb - ha - _union_ms([host[k] for k in kids], ha, hb),
            "self_ms": db - da - _union_ms([dev[k] for k in kids], da, db),
            "children": len(kids),
        })
    return out


def span_table() -> Dict[str, Dict[str, float]]:
    """``spans()`` summed by name, in the order the names first opened:
    calls, host_ms, device_ms, self_host_ms, self_ms and children."""
    table: Dict[str, Dict[str, float]] = {}
    for r in spans():
        row = table.setdefault(r["name"], {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                           "self_host_ms": 0.0, "self_ms": 0.0,
                                           "children": 0})
        row["calls"] += 1
        for k in ("host_ms", "device_ms", "self_host_ms", "self_ms", "children"):
            row[k] += r[k]
    return table


def format_table(table: Dict[str, Dict[str, float]]) -> str:
    """``span_table()`` as aligned text, one span name a line."""
    head = (f"{'span':<22} {'calls':>7} {'host ms':>11} {'device ms':>11} "
            f"{'self host':>11} {'self dev':>11} {'children':>9}")
    lines = [head]
    for name, r in table.items():
        lines.append(f"{name:<22} {r['calls']:>7d} {r['host_ms']:>11.4f} "
                     f"{r['device_ms']:>11.4f} {r['self_host_ms']:>11.4f} "
                     f"{r['self_ms']:>11.4f} {r['children']:>9d}")
    return "\n".join(lines)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Capture a ``torch.profiler`` trace of the block, host and (where
    CUDA is available) device activity, written for TensorBoard's profiler
    plugin to ``log_dir`` (default ``build/gen2_rfid_tpu_torch/trace`` beside
    the package).  The block's spans are a session of their own and are in
    the trace as annotations."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        from ..kernels._build import BUILD_DIR

        log_dir = str(BUILD_DIR / "trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    global _live
    own = _new_session_if_idle()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield log_dir
            _sync()
    finally:
        if own:
            _live = False
