"""Raw I/Q trace file I/O: interleaved float32, GNU Radio file format.

Matches the reference's ``blocks.file_source/file_sink`` byte format
(``apps/reader.py:101-103``): complex64 = interleaved little-endian float32
I,Q pairs, no header - the same layout ``misc/code/plot_signal.m:1-11``
loads.  Memory-maps for large captures so shards can read their slice
without loading the whole file.
"""

from __future__ import annotations

import numpy as np


def read_trace(path: str, offset: int = 0, count: int = -1) -> np.ndarray:
    """Read complex64 samples; offset/count are in complex samples."""
    mm = np.memmap(path, dtype=np.complex64, mode="r")
    if count < 0:
        return np.asarray(mm[offset:])
    return np.asarray(mm[offset : offset + count])


def write_trace(path: str, iq: np.ndarray) -> None:
    np.asarray(iq, dtype=np.complex64).tofile(path)


def trace_num_samples(path: str) -> int:
    import os

    return os.path.getsize(path) // 8
