"""Empirical softfix false-accept campaign, on the port.

    python -m gen2_rfid_tpu_torch.tools.softfix_false_accept [--device cpu]
        [--frames 200000] [--batch 4096] [--seed 0] [--modes native compat]

Twin of ``tools/softfix_false_accept.py``.  Each mode (native: PC-aware
validation, every whole-word EPC length up to the window; compat: the fixed
96-bit check) draws, from its own ``default_rng(seed)``, batches of uniformly
random decoded bits and reliabilities (what noise-only or wrong-tag windows
decode to), runs CRC-guided recovery (``runtime/softfix.py::recover_epc_batch``
with ``runtime/inventory.py::_validate_epc``) on the device, and counts the
frames that some candidate made pass.  The draws are the JAX tool's, so the
counts are too.  ``--modes`` narrows the campaign.  Prints one JSON line per
mode with the measured rate and its 95% Wilson upper bound.
"""

from __future__ import annotations

import argparse
import json
from typing import Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..runtime.inventory import _validate_epc, resolve_device
from ..runtime.softfix import recover_epc_batch
from .sweep import add_device_flag, sweep_device, wall_time

MODES = ("native", "compat")


def wilson_upper(k: int, n: int, z: float = 1.96) -> float:
    if n == 0:
        return 1.0
    p = k / n
    den = 1 + z * z / n
    center = p + z * z / (2 * n)
    rad = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (center + rad) / den


def false_accepts(mode: str, frames: int, batch: int = 4096, seed: int = 0, *,
                  device=None) -> Tuple[int, int]:
    """(frames that recovery made pass, frames drawn): whole batches until
    ``frames`` are drawn, as the JAX tool draws them."""
    dev = resolve_device(device)
    cfg = ReaderConfig(mode=mode, epc_softfix=8)
    n = cfg.epc_bits - 1   # decoded table width (dummy bit excluded)

    def validate(b):
        return _validate_epc(b, cfg)

    rng = np.random.default_rng(seed)
    accepts = done = 0
    while done < frames:
        bits = rng.integers(0, 2, size=(batch, n)).astype(np.int32)
        rel = rng.random((batch, n)).astype(np.float32)
        _, fixed = recover_epc_batch(torch.from_numpy(bits).to(dev),
                                     torch.from_numpy(rel).to(dev), cfg, validate)
        accepts += int(fixed.sum())
        done += batch
    return accepts, done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    p.add_argument("--frames", type=int, default=200_000)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    for mode in args.modes:
        with wall_time(f"softfix_false_accept {mode}", dev):
            accepts, done = false_accepts(mode, args.frames, args.batch, args.seed,
                                          device=dev)
        rate = accepts / done
        print(json.dumps({
            "mode": mode, "frames": done, "false_accepts": accepts,
            "rate": round(rate, 7),
            "wilson95_upper": round(wilson_upper(accepts, done), 7),
            "analytic_single_crc": round(36 / 65536, 7),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
