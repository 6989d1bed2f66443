"""Per-layer metric readers, one module a metric, named as in BENCHMARK.json.

Each module defines ``read(trace) -> float | None``: the metric from a traced
stretch (``rfidbench.trace.Trace``), or None where the trace holds nothing
for it, and the harness then leaves the metric out of the line.
"""
