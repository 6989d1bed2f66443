"""Decode throughput of the port over the eight-case configuration matrix.

    python -m gen2_rfid_tpu_torch.tools.bench_configs [--device cpu]
        [--configs a,b] [--decodes 20] [--rounds R] [--tiles T]

Twin of the root ``bench_configs.py``: the same cases, each with its
configuration, tags, rounds, seeds and tiles (the flagship is ``bench``'s):

* ``multitag_q4``: five tags, ``fixed_q=4`` (collisions and empty slots),
  10 rounds tiled 4 times; 1,280 command events in a 1,536-row table;
* ``miller4``, ``miller2``, ``miller8_trext``: Miller-4 at decim 1, Miller-2,
  and Miller-8 with the TRext pilot at 8 Msps;
* ``blf640``: FM0 at BLF 640 kHz, 8 Msps, decim 2;
* ``blf160``: ``ReaderConfig.for_link(160 kHz, Tari 24 us, DR 64/3)`` at
  2 Msps, decim 1;
* ``wideband8``: a 16 Msps capture with inventories on channels 1 and 6,
  split by ``dsp/channelizer.py::channelize_planar`` into 8 channels and
  decoded by ``shard/decode_sharded.py::make_sharded_decoder`` on a one-card
  mesh (160 events a channel); the decoder is built once, outside the
  timing, and the channelizer runs inside every timed decode;
* ``longcap``: the flagship capture tiled 32 times (38.8 M samples) with a
  6,144-row table and ``max_num_queries`` raised past its 2,560 rounds.

Each case is timed as ``bench`` times the flagship (``bench.py::measure``):
its own first decode untimed, then ``--decodes`` decodes whole, every
count checked (per channel for ``wideband8``); a wrong count prints
``FATAL`` and exits 1.  ``--rounds`` and ``--tiles`` narrow every case.
Prints one JSON line per case: the JAX line's keys (``metric`` =
``iq_decode_throughput[<case>]``, ``samples_per_iter``) and ``bench``'s
added ones (``roles`` for the single-channel cases, ``epcs_by_channel``
for ``wideband8``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..dsp.channelizer import channelize_planar
from ..runtime.inventory import to_planar
from ..shard.decode_sharded import make_sharded_decoder
from ..shard.mesh import make_mesh
from ..sim.tag import Tag
from ..sim.trace import synthesize_inventory
from .bench import CountMismatch, DecodeCase, Workload, add_bench_flags, bench_line, narrowed
from .sweep import sweep_device

TAG27 = ((27, 7, None),)
# Five tags on distinct ids, phases spread by 1.1 rad (bench_configs.py:44-50).
TAGS5 = tuple((i * 17 + 11, i, 0.08 * np.exp(1.1j * i)) for i in range(5))


@dataclasses.dataclass(frozen=True)
class WidebandCase:
    """A ``rate``-samples/s capture of two inventories, (tag, seed, synthesis
    seed) each, ``n_rounds`` long, placed on channels ``chans`` of an
    ``n_chan``-channel filterbank, tiled ``tiles`` times (None: as many
    whole copies as fit in 8 M samples); decoded ``events_per_shard`` rows a
    channel under ``cfg``."""

    cfg: ReaderConfig
    n_chan: int
    rate: float
    inventories: Tuple[Tuple[int, int, int], ...]
    chans: Tuple[int, ...]
    n_rounds: int
    events_per_shard: int
    tiles: Optional[int] = None

    def capture(self) -> Tuple[np.ndarray, Dict[int, Tuple[int, int]]]:
        """(complex64 capture, {channel: (tag id, EPCs a decode)})."""
        synth = ReaderConfig(adc_rate=self.rate)
        trs = [synthesize_inventory(synth, [Tag.with_id(tid, seed=seed)],
                                    n_rounds=self.n_rounds, seed=s, noise=0.0)
               for tid, seed, s in self.inventories]
        n1 = max(tr.iq.size for tr in trs)

        def place(iq, k):
            pad = np.zeros(n1, np.complex64)
            pad[: iq.size] = iq
            return pad * np.exp(2j * np.pi * k * np.arange(n1) / self.n_chan).astype(np.complex64)

        placed = [place(tr.iq, k) for tr, k in zip(trs, self.chans)]
        wide = sum(placed[1:], placed[0])
        rng = np.random.default_rng(5)
        wide += (rng.normal(0, 0.002, n1) + 1j * rng.normal(0, 0.002, n1)).astype(np.complex64)
        reps = self.tiles or max(1, int(8e6 // n1))
        return (np.concatenate([wide] * reps),
                {k: (inv[0], tr.expected_epc_pass * reps)
                 for k, inv, tr in zip(self.chans, self.inventories, trs)})

    def workload(self, dev: torch.device) -> Workload:
        wide, occupied = self.capture()
        x2 = to_planar(wide).to(dev)
        cfg, n_chan = self.cfg, self.n_chan
        m = x2.shape[1] // n_chan
        m_use = m - m % cfg.decim
        decoder = make_sharded_decoder(cfg, make_mesh(1, 1, devices=[dev]),
                                       events_per_shard=self.events_per_shard)
        return Workload(x2, lambda x: decoder(channelize_planar(x, n_chan)[:, :, :m_use]),
                        tuple(occupied.get(k, (0, 0))[1] for k in range(n_chan)))


CASES = {
    "multitag_q4": DecodeCase(ReaderConfig(fixed_q=4, max_events=1536), TAGS5,
                              n_rounds=10, seed=3, tiles=4),
    "miller4": DecodeCase(ReaderConfig(miller_m=4, decim=1, max_events=1280), TAG27,
                          n_rounds=20, seed=2, tiles=24),
    "miller2": DecodeCase(ReaderConfig(miller_m=2, decim=2, max_events=1024), TAG27,
                          n_rounds=20, seed=2, tiles=20),
    "miller8_trext": DecodeCase(ReaderConfig(miller_m=8, trext=1, adc_rate=8e6, decim=2,
                                             max_events=640), TAG27,
                                n_rounds=20, seed=2, tiles=6),
    "blf640": DecodeCase(ReaderConfig(blf_hz=640e3, adc_rate=8e6, decim=2, max_events=768),
                         TAG27, n_rounds=20, seed=2, tiles=13),
    "blf160": DecodeCase(ReaderConfig.for_link(blf_hz=160e3, tari_us=24.0, dr=1,
                                               adc_rate=2e6, decim=1, max_events=1024),
                         TAG27, n_rounds=20, seed=2, tiles=20),
    "wideband8": WidebandCase(ReaderConfig(max_events=256), n_chan=8, rate=16e6,
                              inventories=((27, 7, 3), (99, 9, 4)), chans=(1, 6),
                              n_rounds=6, events_per_shard=160),
    "longcap": DecodeCase(ReaderConfig(max_events=6144, max_num_queries=1_000_000), TAG27,
                          n_rounds=80, seed=2, tiles=32),
}


def bench_case(name: str, decodes: int, dev: torch.device, rounds: Optional[int] = None,
               tiles: Optional[int] = None) -> Dict:
    """One case's JSON line, narrowed to ``rounds`` and ``tiles`` where given."""
    case = narrowed(CASES[name], rounds, tiles)
    return bench_line(f"iq_decode_throughput[{name}]", case, decodes, dev, case != CASES[name])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_bench_flags(p)
    p.add_argument("--configs", default=",".join(CASES),
                   help="comma-separated cases (default: all eight, in order)")
    args = p.parse_args(argv)
    names = [n.strip() for n in args.configs.split(",")]
    unknown = [n for n in names if n not in CASES]
    if unknown:
        p.error(f"unknown cases {unknown}; choose from {list(CASES)}")
    dev = sweep_device(args.device)
    for name in names:
        try:
            line = bench_case(name, args.decodes, dev, args.rounds, args.tiles)
        except CountMismatch as err:
            print(f"FATAL: {err}", file=sys.stderr)
            return 1
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
