"""Sharded capture decode: overlap-save time blocks and channel parallelism.

PyTorch counterpart of ``gen2_rfid_tpu/shard/decode_sharded.py``.  A planar
(C, 2, N) capture is laid over a (time, chan) mesh (shard/mesh.py): time
shard t of channel group k holds samples [t*N/n_time, (t+1)*N/n_time) of
channels [k*C/n_chan, (k+1)*C/n_chan).  Then

* each position's block takes a left and a right halo from its time
  neighbours' blocks, moved to its device (the JAX package's ``ppermute``;
  on one card the move is none); a missing neighbour gives zeros, which
  is the capture's zero history at the first shard and its zero tail at
  the last.  ``block_span`` holds that rule, for the blocks cut here and
  for those that shard/distributed.py reads from a file;
* each block's front end (``gate_block``: one ``gate_front`` launch,
  ``_fir_valid``'s y build native, ``front_valid``'s full build compat),
  gate (native: one ``gate_stack`` launch) and decode run on its device; the
  blocks that share a device decode as one batch (``decode_events_multi``
  over every channel of every such position, native mode), since every
  extended block has the same length;
* an event belongs to the shard whose block holds its trigger, so each is
  decoded once; each shard's table carries global indices, and the rows it
  does not own sort last;
* the tables are joined in time-shard order, stable-sorted by index per
  channel, cut to ``max_events`` and replayed per channel.

The JAX module's ``_event_out_specs`` (shard_map's output layout) has no
counterpart: the tables are joined by hand.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..dsp.gate import GateEvents, full_build, gate_detect, gate_input
from ..kernels.gate_front import front_taps, gate_front, gate_front_y
from ..runtime.inventory import (DecodedEvents, decode_events, decode_events_multi,
                                 replay_inventory, replay_inventory_batch)
from ..runtime.stats import InventoryStats
from .mesh import CHAN_AXIS, TIME_AXIS, Mesh

# Index of a table row its shard does not own: it sorts after every real
# event.
UNOWNED = 1 << 30


def halo_sizes(cfg: ReaderConfig) -> Tuple[int, int]:
    """(left, right) halo in post-decimation samples (decode_sharded.py:42-56).

    Left: the longest command (Query: preamble + 22 max-length PIE bits) +
    T1 quiet + the moving-average window + margin, enough to rebuild the gate
    state at a block boundary.  Right: a trigger on the last owned sample
    still needs its whole EPC window."""
    cmd_us = (
        cfg.delim_us + 2 * cfg.pw_us + 8 * cfg.pw_us + cfg.trcal_us
        + cfg.query_length * 4 * cfg.pw_us
    )
    left = int(cmd_us * cfg.sample_rate / 1e6) + cfg.n_samples_t1 + cfg.win_length + 64
    right = cfg.epc_window + 64
    return left, right


def front_input(x2: torch.Tensor, cfg: ReaderConfig) -> Tuple[torch.Tensor, int, int]:
    """(xp, k0, n_valid): the block as ``front_valid`` and ``_fir_valid`` hand
    it to the front end, left-padded by p = decim*ceil((T-1)/decim) - (T-1)
    zeros and right-padded to room for the last valid output, with the first
    kept output k0 and the count n_valid of outputs whose taps lie in the
    block."""
    n_taps, decim = front_taps(cfg), cfg.decim
    n = x2.shape[1]
    n_valid = max((n - n_taps) // decim + 1, 0)
    p = decim * -(-(n_taps - 1) // decim) - (n_taps - 1)
    k0 = (n_taps - 1 + p) // decim
    right = max((k0 + n_valid) * decim - (n + p), 0)
    xp = torch.cat([x2.new_zeros((2, p)), x2, x2.new_zeros((2, right))], dim=1)
    return xp.contiguous(), k0, n_valid


def front_valid(x2: torch.Tensor, cfg: ReaderConfig) -> Tuple[torch.Tensor, ...]:
    """The front end's full build over a block with no implicit history (what
    compat mode's gate reads): (y2, amp, avgsum) with y[k] = sum_{j<T}
    x[k*decim + j] for every k whose taps lie in the block
    (decode_sharded.py:59-73's valid FIR with the boxcar taps).

    One ``gate_front`` launch (the kernel on CUDA, its plain version on the
    CPU) on ``front_input``'s padded block, so that output k0 of the
    zero-history FIR is y[0], summed in the same tap order; the outputs
    before it are dropped.  amp is |y|; avgsum is the windowed |y| sum over
    the valid y alone, zero history, as the JAX package's gate takes it from
    _fir_valid's y: the kernel's first win-1 sums also hold the dropped
    outputs' |y|, so those restart at y[0] as a running sum of the kept
    amp."""
    xp, k0, n_valid = front_input(x2, cfg)
    y2, amp, avgsum, _ = gate_front(xp, cfg.decim, front_taps(cfg), cfg.win_length,
                                    cfg.dc_length)
    cut = slice(k0, k0 + n_valid)
    amp, avgsum = amp[cut], avgsum[cut]
    head = min(cfg.win_length - 1, n_valid)
    avgsum = torch.cat([torch.cumsum(amp[:head], 0), avgsum[head:]])
    return y2[:, cut].contiguous(), amp, avgsum


def _fir_valid(x2: torch.Tensor, cfg: ReaderConfig) -> torch.Tensor:
    """(2, n_valid) y of ``front_valid``, bit for bit, from one launch of the
    front end's y build: the matched filter over a block without implicit
    history (decode_sharded.py:59-73), what the native gate reads."""
    xp, k0, n_valid = front_input(x2, cfg)
    y2 = gate_front_y(xp, cfg.decim, front_taps(cfg))
    return y2[:, k0:k0 + n_valid].contiguous()


@functools.lru_cache(maxsize=32)
def _with_cap(cfg: ReaderConfig, cap: int) -> ReaderConfig:
    return dataclasses.replace(cfg, max_events=cap)


def _halo_x(cfg: ReaderConfig, n_loc: int) -> Tuple[int, int]:
    """(left, right) halo in ADC samples of a block of ``n_loc``: the gate's
    halos, plus the FIR's T-1 on the left (decode_sharded.py:95-98), each at
    most the neighbour's whole block, as the JAX package slices it."""
    hl_y, hr_y = halo_sizes(cfg)
    return (min(hl_y * cfg.decim + front_taps(cfg) - 1, n_loc),
            min(hr_y * cfg.decim, n_loc))


def block_span(t: int, n_block: int, n_used: int, halo: Tuple[int, int]
               ) -> Tuple[int, int, int, int]:
    """(a, b, pad_l, pad_r): time shard t's extended block, its block
    [t*n_block, (t+1)*n_block) between halos ``halo`` = (hl_x, hr_x), is
    samples [a, b) of the capture with pad_l zeros before them and pad_r
    after.  Zeros stand outside [0, n_used): the first shard's zero history
    and the last one's zero tail, whatever the capture holds past n_used."""
    hl_x, hr_x = halo
    lo, hi = t * n_block - hl_x, (t + 1) * n_block + hr_x
    a, b = max(lo, 0), min(hi, n_used)
    return a, b, a - lo, hi - b


def extended_block(x: torch.Tensor, t: int, n_block: int, halo: Tuple[int, int],
                   device=None) -> torch.Tensor:
    """Time shard t's extended block of a planar (..., 2, N) capture cut into
    blocks of ``n_block`` (``block_span``), moved to ``device``: the
    neighbours' block edges its halos, zeros past the capture's ends."""
    a, b, pad_l, pad_r = block_span(t, n_block, x.shape[-1], halo)
    return torch.nn.functional.pad(x[..., a:b].to(device or x.device), (pad_l, pad_r))


def gate_block(x2: torch.Tensor, cfg: ReaderConfig, cap_cfg: ReaderConfig):
    """(y, events) of a block without implicit history: one ``gate_front``
    launch, ``front_valid``'s full build where the gate reads |y| (compat,
    dsp/gate.py::full_build) and ``_fir_valid``'s y build elsewhere, then
    the gate at ``cap_cfg``'s capacity on what ``gate_input`` forms of it:
    |y| and its windowed average, or ``gate_stack``'s flags of y (one
    launch)."""
    y2, *amp_sum = front_valid(x2, cfg) if full_build(cfg) else (_fir_valid(x2, cfg),)
    y, flags, amp, avg = gate_input(y2, cfg, *amp_sum)
    return y, gate_detect(y, cap_cfg, flags, amp, avg)


def _shard_body(x_ext: torch.Tensor, me: Sequence[int], *, cfg: ReaderConfig,
                events_cap: int, n_y: int) -> Tuple[DecodedEvents, torch.Tensor]:
    """Decode the extended blocks that one device holds
    (decode_sharded.py:81-137).

    x_ext: (B, 2, hl_x + n_loc + hr_x) float32 planar, one row per channel of
    each mesh position on the device, each its block between its halos; me:
    the B rows' time-shard indices; n_y: a block's post-decimation length.
    Each row gets its front end and gate (``gate_block``); it owns the
    events whose trigger lies in [hl_y, hl_y + n_y).  Native mode decodes
    every row's owned events as one batch, compat mode row by row and
    paranoid.
    Returns (B, events_cap) tables with global indices, unowned rows at
    ``UNOWNED`` and valid False, and the (B,) triggers each row's gate
    found, halo included, before the table's capacity cut them."""
    hl_y, _ = halo_sizes(cfg)
    cap_cfg = _with_cap(cfg, events_cap)
    ys, evs = [], []
    for x2 in x_ext:
        y, events = gate_block(x2, cfg, cap_cfg)
        owned = events.valid & (events.index >= hl_y) & (events.index < hl_y + n_y)
        ys.append(y)
        evs.append(events._replace(valid=owned))
    events_c = GateEvents(*(torch.stack(f) for f in zip(*evs)))
    if cfg.mode == "compat":
        decs = [decode_events(y, ev, cfg, specialize=False, overflow_fallback=False)
                for y, ev in zip(ys, evs)]
        dec = DecodedEvents(*(torch.stack(f) for f in zip(*decs)))
    else:
        dec = decode_events_multi(torch.stack(ys), events_c, cfg)
    g0 = torch.as_tensor(np.asarray(me, np.int32), device=x_ext.device)[:, None] * n_y - hl_y
    dec = dec._replace(index=torch.where(events_c.valid, dec.index + g0, UNOWNED),
                       valid=events_c.valid)
    return dec, events_c.n_events


def _sort_events(dec_c: DecodedEvents, cfg: ReaderConfig) -> DecodedEvents:
    """Joined shard tables, stably sorted by index along the table axis (the
    last axis of ``index``: one channel's (E,) leaves or C channels' (C, E))
    and cut to ``cfg.max_events`` rows (decode_sharded.py:156-160)."""
    axis = dec_c.index.dim() - 1
    order = torch.sort(dec_c.index, dim=axis, stable=True).indices
    keep = min(cfg.max_events, order.shape[axis])

    def take(a):
        o = order.reshape(order.shape + (1,) * (a.dim() - order.dim()))
        return torch.gather(a, axis, o.expand(order.shape + a.shape[order.dim():])
                            ).narrow(axis, 0, keep)

    return DecodedEvents(*(take(a) for a in dec_c))


def _sort_and_replay(dec_c: DecodedEvents, cfg: ReaderConfig) -> InventoryStats:
    """One channel's joined shard tables -> the global replay."""
    return replay_inventory(_sort_events(dec_c, cfg), cfg)


class ShardedDecoder:
    """The decode of a planar (C, 2, N) capture on a mesh
    (decode_sharded.py:180-215); ``make_sharded_decoder`` is its JAX name.

    ``decoder(iq2)`` -> (per-channel InventoryStats, leaves stacked on a
    leading channel axis; the joined, unsorted tables, (C, n_time *
    events_per_shard) in time-shard order), both on the mesh's first
    device.  N divides by n_time and C by n_chan.  ``decoder(iq2,
    with_gated=True)`` adds a third output: the (n_time, C) triggers each
    block's gate found, halo included, before its table's capacity; a count
    over ``events_per_shard`` means that block dropped events."""

    def __init__(self, cfg: ReaderConfig, mesh: Mesh, events_per_shard: int = 256):
        self.cfg, self.mesh, self.events_per_shard = cfg, mesh, events_per_shard
        self.n_time, self.n_chan = mesh.shape[TIME_AXIS], mesh.shape[CHAN_AXIS]
        self.by_device = {}
        for t in range(self.n_time):
            for k in range(self.n_chan):
                self.by_device.setdefault(mesh.devices[t, k], []).append((t, k))

    def __call__(self, iq2: torch.Tensor, with_gated: bool = False):
        cfg, n_time, n_chan = self.cfg, self.n_time, self.n_chan
        home = self.mesh.devices[0, 0]
        c, _, n = iq2.shape
        n_loc, c_loc = n // n_time, c // n_chan
        halo = _halo_x(cfg, n_loc)

        tables, gated = {}, {}
        for dev, positions in self.by_device.items():
            # The halo exchange: each block with its neighbours' edges, moved here.
            ext = [extended_block(iq2[k * c_loc:(k + 1) * c_loc], t, n_loc, halo, dev)
                   for t, k in positions]
            me = [t for t, _ in positions for _ in range(c_loc)]
            dec, n_gated = _shard_body(torch.cat(ext), me, cfg=cfg,
                                       events_cap=self.events_per_shard, n_y=n_loc // cfg.decim)
            for p, pos in enumerate(positions):
                rows = slice(p * c_loc, (p + 1) * c_loc)
                tables[pos] = DecodedEvents(*(f[rows].to(home) for f in dec))
                gated[pos] = n_gated[rows].to(home)
        dec = DecodedEvents(*(
            torch.cat([torch.cat([getattr(tables[t, k], f) for t in range(n_time)], 1)
                       for k in range(n_chan)], 0)
            for f in DecodedEvents._fields))
        stats = replay_inventory_batch(_sort_events(dec, cfg), cfg)
        if not with_gated:
            return stats, dec
        return stats, dec, torch.stack([torch.cat([gated[t, k] for k in range(n_chan)])
                                        for t in range(n_time)])


make_sharded_decoder = ShardedDecoder


def _run_sharded_planar(iq2: torch.Tensor, cfg: ReaderConfig, mesh: Mesh,
                        events_per_shard: int) -> Tuple[InventoryStats, DecodedEvents]:
    """The sharded decode of a (C, 2, N) planar capture, under the JAX
    module's name."""
    return ShardedDecoder(cfg, mesh, events_per_shard)(iq2)


def decode_capture_sharded(iq, cfg: ReaderConfig, mesh: Mesh, events_per_shard: int = 256
                           ) -> Tuple[InventoryStats, DecodedEvents]:
    """Decode a (C, N) multi-channel ADC-rate capture (a host complex array)
    on a (time, chan) mesh (decode_sharded.py:163-177): planar (C, 2, N)
    float32 on the mesh's first device, then ``ShardedDecoder``.  N must
    divide by n_time * decim and C by n_chan."""
    n_time, n_chan = mesh.shape[TIME_AXIS], mesh.shape[CHAN_AXIS]
    iq = np.asarray(iq)
    c, n = iq.shape
    if n % (n_time * cfg.decim) or c % n_chan:
        raise ValueError(f"capture ({c}, {n}) does not split over {n_time} time shards "
                         f"of a multiple of decim={cfg.decim} and {n_chan} channel groups")
    iq2 = torch.from_numpy(np.stack([iq.real, iq.imag], axis=1).astype(np.float32))
    return ShardedDecoder(cfg, mesh, events_per_shard)(iq2.to(mesh.devices[0, 0]))
