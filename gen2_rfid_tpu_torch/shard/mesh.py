"""Device mesh for the sharded capture decode.

PyTorch counterpart of ``gen2_rfid_tpu/shard/mesh.py``.  Mesh axes:

* ``time`` - overlap-save time blocks of one long capture; each position
  takes its halos from its neighbours' blocks;
* ``chan`` - independent frequency channels or antennas.

A mesh is a ``(n_time, n_chan)`` grid of ``torch.device``s.  One device may
fill several positions (virtual shards): ``make_mesh(8, devices=[cuda0] * 8)``
decodes eight time blocks on one card, as the JAX package's tests decode
them on eight forced CPU devices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

TIME_AXIS = "time"
CHAN_AXIS = "chan"


class Mesh:
    """``devices``: (n_time, n_chan) object array of ``torch.device``;
    ``shape``: {TIME_AXIS: n_time, CHAN_AXIS: n_chan}."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape: Dict[str, int] = {TIME_AXIS: devices.shape[0],
                                      CHAN_AXIS: devices.shape[1]}

    def __repr__(self) -> str:
        return f"Mesh(time={self.shape[TIME_AXIS]}, chan={self.shape[CHAN_AXIS]})"


def make_mesh(n_time: Optional[int] = None, n_chan: int = 1, devices=None) -> Mesh:
    """A (time, chan) mesh over ``devices`` (mesh.py:24-32), every CUDA device
    when none are given; without CUDA that raises: the mesh never falls back
    to the CPU on its own.  ``n_time=None`` takes len(devices) // n_chan."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_time is None:
        n_time = len(devices) // n_chan
    if n_time * n_chan > len(devices):
        raise ValueError(f"a {n_time} x {n_chan} mesh needs {n_time * n_chan} devices, "
                         f"got {len(devices)}")
    grid = np.empty(n_time * n_chan, dtype=object)
    grid[:] = devices[: n_time * n_chan]
    return Mesh(grid.reshape(n_time, n_chan))
