"""Sharded decode throughput at 1 and n time positions, and its efficiency.

    python -m gen2_rfid_tpu_torch.tools.bench_scaling [--device cpu]
        [--positions N] [--decodes 20] [--rounds R] [--tiles T]

Twin of the root ``bench_scaling.py``: ``ReaderConfig(max_events=2048)``,
tag 27 (seed 7), 40 rounds at seed 2, tiled ``max(2, n)`` times and
zero-padded to a multiple of ``n * decim``, decoded by
``shard/decode_sharded.py::make_sharded_decoder`` on a ``(n_time, 1)`` mesh
with ``max_events // n_time`` events a shard, at n_time 1 and n:

    efficiency = throughput(n) / (n * throughput(1))

``n`` is every CUDA device (``torch.cuda.device_count()``; one H100 gives
the degenerate n = 1, efficiency 1.0), or ``--positions N`` time positions
laid on the one device, as the JAX harness lays them on virtual CPU
devices.  Every position is then the same card: that efficiency is no
scaling claim, only a measure of what splitting a capture into N blocks
costs on one device.

Each decode is timed whole as ``bench`` times the flagship
(``bench.py::measure``).  The JAX harness only warns on a wrong EPC count;
this twin checks every decode's count, prints ``FATAL`` and exits 1.
``--rounds`` and ``--tiles`` narrow the capture.

Prints ONE JSON line, its numbers unrounded: the JAX line's ``metric`` (``scaling_efficiency``),
``value``, ``unit``, ``n_devices`` (distinct devices), ``msps_1``,
``msps_n`` and ``per_device_msps_n``, then ``positions``, ``device``,
``power_limit_w``, ``decodes``, ``epcs``, ``samples_per_iter``,
``peak_mem_bytes``, ``narrowed``, and by n_time (``"1"``, ``"n"``) the
median ``decode_ms``, ``first_decode_ms``, ``band`` and ``launches``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ReaderConfig
from ..runtime.inventory import to_planar
from ..shard.decode_sharded import make_sharded_decoder
from ..shard.mesh import make_mesh
from .bench import (
    CountMismatch, DecodeCase, Workload, add_bench_flags, card, measure, narrowed,
    peak_bytes, positive, reset_peak)
from .sweep import sweep_device

# Tiled max(2, n) times at n positions (``scaling_case``).
CASE = DecodeCase(ReaderConfig(max_events=2048), ((27, 7, None),), n_rounds=40, seed=2,
                  tiles=2)


def scaling_case(n: int, rounds: Optional[int] = None, tiles: Optional[int] = None
                 ) -> DecodeCase:
    """``CASE`` for n positions, narrowed where asked."""
    return narrowed(dataclasses.replace(CASE, tiles=max(2, n)), rounds, tiles)


def workloads(case: DecodeCase, devices: Sequence[torch.device]) -> Dict[int, Workload]:
    """The (1, 2, N) capture, padded to a multiple of n * decim, on the first
    device, and its decoders at n_time 1 and n = len(devices)."""
    n = len(devices)
    iq, epcs = case.capture()
    iq = np.concatenate([iq, np.zeros((-iq.size) % (n * case.cfg.decim), np.complex64)])
    x2 = to_planar(iq)[None].to(devices[0])
    cfg = case.cfg
    out = {}
    for n_time in sorted({1, n}):
        decoder = make_sharded_decoder(cfg, make_mesh(n_time, 1, devices=devices[:n_time]),
                                       events_per_shard=cfg.max_events // n_time)
        out[n_time] = Workload(x2, decoder, (epcs,))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_bench_flags(p)
    p.add_argument("--positions", type=positive, default=None,
                   help="time positions laid on the one device (default: one on each "
                        "CUDA device, or one on the CPU)")
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    if args.positions is not None:
        devices = [dev] * args.positions
    elif dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    case = scaling_case(n, args.rounds, args.tiles)
    ws = workloads(case, devices)
    reset_peak(devices[0])
    try:
        timings = {k: measure(w, args.decodes, f"scaling n_time={k}") for k, w in ws.items()}
    except CountMismatch as err:
        print(f"FATAL: {err}", file=sys.stderr)
        return 1
    samples, epcs = ws[1].x2.shape[-1], sum(ws[1].epcs)
    msps = {k: samples / float(np.median(t.seconds)) / 1e6 for k, t in timings.items()}
    name, limit = card(devices[0])
    by_n = {"1": 1, "n": n}
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": msps[n] / (n * msps[1]) if n > 1 else 1.0,
        "unit": "fraction",
        "n_devices": len(set(devices)),
        "msps_1": msps[1],
        "msps_n": msps[n],
        "per_device_msps_n": msps[n] / len(set(devices)),
        "positions": n,
        "device": name,
        "power_limit_w": limit,
        "decodes": args.decodes,
        "epcs": epcs,
        "samples_per_iter": int(samples),
        "peak_mem_bytes": peak_bytes(devices[0]),
        "narrowed": case != scaling_case(n),
        "decode_ms": {k: float(np.median(timings[v].seconds)) * 1e3 for k, v in by_n.items()},
        "first_decode_ms": {k: timings[v].first_s * 1e3 for k, v in by_n.items()},
        "band": {k: [samples / max(timings[v].seconds) / 1e6,
                     samples / min(timings[v].seconds) / 1e6] for k, v in by_n.items()},
        "launches": {k: timings[v].launches for k, v in by_n.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
