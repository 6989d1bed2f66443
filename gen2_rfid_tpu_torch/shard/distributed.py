"""Multi-process decode of one capture file.

PyTorch counterpart of ``gen2_rfid_tpu/shard/distributed.py``.  The capture
is cut into ``num_processes * shards_per_process`` time shards, as the
sharded decode cuts it (shard/decode_sharded.py); then

* ``init_distributed`` joins a ``torch.distributed`` process group over gloo
  (a no-op for one process);
* each process reads only its own shards' blocks and their halos from the
  file (``io/tracefile.py``): the samples a neighbour's halo exchange would
  deliver, so no capture samples cross processes;
* it decodes them on its device (``_shard_body``: the front kernels, the
  gate, the decode), copies its tables to the host once, packed, and
  all-gathers them over gloo: a few KB;
* every process joins the tables in time-shard order, sorts and replays
  them on its own device, so every process holds the same stats, as the
  JAX package's replicated outputs give.

Gloo carries only the event tables; the decode runs on the device.  A
device-side gather (NCCL) needs one card per process.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ReaderConfig
from ..io.tracefile import read_trace, trace_num_samples
from ..runtime.inventory import DecodedEvents, replay_inventory_batch, resolve_device
from ..runtime.stats import InventoryStats
from .decode_sharded import _halo_x, _shard_body, _sort_events, block_span


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the gloo process group at ``coordinator_address`` (host:port of
    process 0) as ``process_id`` of ``num_processes``; a no-op when one
    process is configured and no coordinator named."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs its coordinator, size and rank")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def stats_to_host(stats: InventoryStats) -> InventoryStats:
    """The stats with numpy leaves."""
    return InventoryStats(*(t.cpu().numpy() for t in stats))


def _planar_slice(path: str, offset: int, count: int) -> np.ndarray:
    iq = read_trace(path, offset, count)
    return np.stack([iq.real.astype(np.float32), iq.imag.astype(np.float32)])


def _pack(dec: DecodedEvents) -> torch.Tensor:
    """(B, E, ...) tables -> one (B, E, K) int32 tensor: ints and bools as
    values, floats as their bits."""
    cols = []
    for f in dec:
        f = f if f.dim() == 3 else f[..., None]
        cols.append(f.view(torch.int32) if f.dtype == torch.float32 else f.to(torch.int32))
    return torch.cat(cols, dim=2)


def _unpack(packed: torch.Tensor, like: DecodedEvents) -> DecodedEvents:
    out, k = [], 0
    for f in like:
        w = f.shape[2] if f.dim() == 3 else 1
        col = packed[..., k:k + w].contiguous()
        col = col.view(torch.float32) if f.dtype == torch.float32 else col.to(f.dtype)
        out.append(col if f.dim() == 3 else col[..., 0])
        k += w
    return DecodedEvents(*out)


def decode_file_distributed(path: str, cfg: ReaderConfig, n_chan: int = 1,
                            events_per_shard: int = 256, device=None,
                            shards_per_process: int = 1
                            ) -> Tuple[InventoryStats, DecodedEvents]:
    """Decode a single-channel capture file across the process group
    (distributed.py:75-119), on CUDA unless ``device`` says otherwise.

    The file is cut to ``n_used`` samples, a multiple of the global shard
    count times decim.  Each process reads its ``shards_per_process``
    blocks and their halos, zeros outside [0, n_used) as at the mesh's
    ends, decodes them on its device and all-gathers the tables.  Returns
    (stats, the joined tables (1, n_shards * events_per_shard)), the same on
    every process.  The file holds one channel: ``n_chan`` is there for the
    JAX signature's sake and must be 1."""
    if n_chan != 1:
        raise ValueError(f"a capture file holds one channel, not n_chan={n_chan}")
    dev = resolve_device(device)
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    n_time = world * shards_per_process
    n = trace_num_samples(path)
    n_block = (n // (n_time * cfg.decim)) * cfg.decim
    n_used = n_block * n_time
    halo = _halo_x(cfg, n_block)
    mine = range(rank * shards_per_process, (rank + 1) * shards_per_process)
    ext = np.zeros((len(mine), 2, sum(halo) + n_block), np.float32)
    for row, t in enumerate(mine):
        a, b, pad_l, _ = block_span(t, n_block, n_used, halo)
        ext[row, :, pad_l:pad_l + b - a] = _planar_slice(path, a, b - a)
    dec, _ = _shard_body(torch.from_numpy(ext).to(dev), list(mine), cfg=cfg,
                         events_cap=events_per_shard, n_y=n_block // cfg.decim)
    packed = _pack(dec).cpu()
    if world > 1:
        parts = [torch.empty_like(packed) for _ in range(world)]
        dist.all_gather(parts, packed)
        packed = torch.cat(parts)
    # (n_time, cap, ...) in time-shard order -> one channel's joined table.
    joined = DecodedEvents(*(f.reshape((1, -1) + f.shape[2:]).to(dev)
                             for f in _unpack(packed, dec)))
    return replay_inventory_batch(_sort_events(joined, cfg), cfg), joined
