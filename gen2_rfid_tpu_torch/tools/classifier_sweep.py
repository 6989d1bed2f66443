"""The slot-state classifier across SNR x collider-phase grids, on the port.

    python -m gen2_rfid_tpu_torch.tools.classifier_sweep [--device cpu]
        [--noises 0.016 ...] [--dphi-index 0 2 ...]

Twin of ``tools/classifier_sweep.py``: per-class accuracy (empty, single,
collision) of ``runtime/inventory.py::classify_slots`` over 6 noise levels x
6 phase separations of two equal-amplitude colliding tags, 3 seeds a cell,
each a 12-round ``fixed_q=1`` inventory zero-padded to 2^21 ADC samples (the
JAX tool's fixed decode shape).  ``--noises`` and ``--dphi-index`` (indices
into the phase separations 0, pi/6, ..., 5pi/6) narrow the grid.  Prints the
JAX tool's markdown table.
"""

from __future__ import annotations

import argparse
import collections

import numpy as np

from ..carry import decoded_to_numpy
from ..config import ReaderConfig
from ..runtime.inventory import (
    CMD_QREP,
    CMD_QUERY,
    SLOT_COLLISION,
    SLOT_EMPTY,
    SLOT_SINGLE,
    decode_capture,
)
from ..sim.tag import Tag
from ..sim.trace import synthesize_inventory
from .sweep import add_device_flag, sweep_device, wall_time

_NAMES = {SLOT_EMPTY: "empty", SLOT_SINGLE: "single",
          SLOT_COLLISION: "collision"}
PAD_TO = 1 << 21        # fixed decode shape: zero-pad every trace to 2^21 ADC samples
NOISES = (0.004, 0.016, 0.032, 0.064, 0.128, 0.192)
DPHIS = (0.0, np.pi / 6, np.pi / 3, np.pi / 2, 2 * np.pi / 3, 5 * np.pi / 6)
SEEDS = (3, 17, 31)


def cell_confusion(noise: float, dphi: float, *, n_rounds: int = 12,
                   seed: int = 3, device=None) -> collections.Counter:
    """(truth, predicted) counts for one (noise, phase-separation) cell."""
    cfg = ReaderConfig(fixed_q=1, max_events=128)
    tags = [
        Tag.with_id(9, seed=seed, backscatter=0.08 + 0j),
        Tag.with_id(27, seed=seed + 1,
                    backscatter=0.08 * np.exp(1j * dphi)),
    ]
    tr = synthesize_inventory(cfg, tags, n_rounds=n_rounds, seed=seed,
                              noise=noise)
    truth = ["collision" if e.collided
             else ("single" if e.reply_tag is not None else "empty")
             for e in tr.events if e.kind in ("query", "query_rep")]
    iq = np.zeros(PAD_TO, np.complex64)
    assert tr.iq.size <= PAD_TO, tr.iq.size
    iq[: tr.iq.size] = tr.iq
    _, dec = decode_capture(iq, cfg, device=device)
    d = decoded_to_numpy(dec)
    valid = d["valid"]
    order = np.argsort(d["index"][valid])
    states = d["slot_state"][valid][order]
    cmds = d["cmd_type"][valid][order]
    pred = [_NAMES[int(s)] for s, c in zip(states, cmds)
            if c in (CMD_QUERY, CMD_QREP)]
    assert len(pred) == len(truth), (len(pred), len(truth))
    return collections.Counter(zip(truth, pred))


def accuracy(conf: collections.Counter, cls: str) -> float:
    tot = sum(v for (t, _), v in conf.items() if t == cls)
    if tot == 0:
        return float("nan")
    return conf[(cls, cls)] / tot


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    p.add_argument("--noises", nargs="+", type=float, default=list(NOISES),
                   help="complex AWGN std at the ADC rate (default: the JAX tool's six)")
    p.add_argument("--dphi-index", nargs="+", type=int, default=list(range(len(DPHIS))),
                   choices=range(len(DPHIS)), help="phase separations k*pi/6 to run")
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    with wall_time("classifier_sweep", dev):
        print("| noise | ~SNR dB | dphi | empty | single | collision |")
        print("|---|---|---|---|---|---|")
        for noise in args.noises:
            snr = 20 * np.log10(0.08 / (noise / np.sqrt(25)))
            for dphi in (DPHIS[k] for k in args.dphi_index):
                conf = collections.Counter()
                for seed in SEEDS:
                    conf += cell_confusion(noise, dphi, seed=seed, device=dev)
                e, s, c = (accuracy(conf, k) for k in ("empty", "single",
                                                       "collision"))
                print(f"| {noise} | {snr:.0f} | {dphi / np.pi:.2f}pi "
                      f"| {e:.2f} | {s:.2f} | {c:.2f} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
