"""Reading a traced stretch of decodes from ``torch.profiler``'s trace.

``traced(fn, decodes)`` runs ``fn`` ``decodes`` times under the profiler,
each call inside a ``rfidbench.decode`` annotation and all of them inside
``rfidbench.stretch``, which ends after a device synchronize; it exports
the Chrome trace to a temporary file, reads it and deletes it.  ``Trace``
holds what the per-layer readers (``rfidbench/metrics/``) read: the device
operations (kernels, copies, fills) inside the stretch, their busy time as
the union of their intervals, the stretch's wall, and the host operations
for labelling the device's idle gaps.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def function_name(name: str) -> str:
    """A kernel's function name from its demangled signature: no return
    type, namespace, template arguments or argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.split(" ")[-1].split("::")[-1]


@dataclass
class Op:
    name: str
    start: float     # microseconds, the trace's clock
    dur: float


@dataclass
class Trace:
    device: List[Op]                  # device ops inside the stretch, by start
    host: List[Op]                    # host ops inside the stretch
    start: float                      # the stretch, microseconds
    end: float
    decodes: int
    shapes: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals, clipped to the stretch."""
        out: List[Tuple[float, float]] = []
        for op in self.device:
            a, b = max(op.start, self.start), min(op.start + op.dur, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, function: str) -> List[float]:
        """Each launch's device seconds of the kernels named ``function``
        (``function_name``)."""
        return [op.dur * 1e-6 for op in self.device if function_name(op.name) == function]

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations by device seconds over the stretch, and
        the ten longest idle gaps, each by the innermost host operation
        running at its middle (``python`` where none was)."""
        by_name: Dict[str, float] = {}
        for op in self.device:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        edges = [self.start]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[name[:120], s] for name, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), (b - a) * 1e-6] for a, b in gaps]}

    def host_at(self, t: float) -> str:
        inside = [op for op in self.host if op.start <= t <= op.start + op.dur]
        return min(inside, key=lambda op: op.dur).name[:120] if inside else "python"


def read_chrome_trace(path: str, decodes: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in spans if e.get("name") == "rfidbench.stretch"
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no rfidbench.stretch annotation")
    start = float(stretch[0]["ts"])
    end = start + float(stretch[0]["dur"])

    def ops(cats):
        out = [Op(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in spans
               if e.get("cat") in cats and start <= float(e["ts"]) < end]
        return sorted(out, key=lambda op: op.start)

    return Trace(ops(DEVICE_CATS), ops(HOST_CATS), start, end, decodes)


def traced(fn, decodes: int) -> Trace:
    """Run ``fn()`` ``decodes`` times under the profiler and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function("rfidbench.stretch"):
            for _ in range(decodes):
                with record_function("rfidbench.decode"):
                    fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="rfidbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, decodes)
    finally:
        os.unlink(path)
