"""Device (H100): the caching allocator's new segments a decode, each a
``cudaMalloc``: the root span's ``segment_allocs``, the change of
``torch.cuda.memory_stats``' ``segment.all.allocated`` over the decode."""

from ._spans import ROOT, session


def read(trace):
    rows = session(trace)
    if rows is None:
        return None
    counts = [r["attrs"].get("segment_allocs") for r in rows if r["name"] == ROOT]
    if None in counts:
        return None
    return sum(counts) / trace.decodes
