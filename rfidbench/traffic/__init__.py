"""Traffic: one data file a mix (``<traffic>.json``, named in BENCHMARK.json)
and one module a generator (``<generator>.py``, named in the data file)."""
