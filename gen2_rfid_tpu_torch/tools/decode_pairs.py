"""Decode wall time of two checkouts of the port, in alternating processes.

    python -m gen2_rfid_tpu_torch.tools.decode_pairs BEFORE AFTER [--blocks 4] [--decodes 11]

BEFORE and AFTER are the roots of two checkouts of the repository.  The
runs go in blocks of BEFORE, AFTER, AFTER, BEFORE, so that drift of the
card or the host over a block falls on both sides alike.  Each run is a
fresh process started in its root, which imports that root's port, builds
its kernels, synthesizes the captures of ``CASES`` (``chip_smoke.py``'s:
tag 27 seed 7, simulator seed 2, tiled; ``compat_bench`` is the bench
capture in compat mode), decodes each once and then times ``--decodes``
decodes of each on the card (``utils.timing.cuda_ms``: the
median; a decode waits on the device, so that is its wall time).

Prints the card's name and power limit (``nvidia-smi``) first, then one
JSON line a run, then one a case: every run's ms on each side,
each block's AFTER - BEFORE (the mean of its two AFTER runs less the mean
of its two BEFORE runs) and how many blocks AFTER won.  A run whose EPC
count differs from BEFORE's first fails the script.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# name, ReaderConfig keywords, rounds, tiles.
CASES = (
    ("fm0_8msps", dict(adc_rate=8e6, decim=1, max_events=256), 20, 2),
    ("fm0_16msps", dict(adc_rate=16e6, decim=1, max_events=256), 10, 2),
    ("miller4", dict(miller_m=4, decim=1, max_events=1280), 20, 24),
    ("compat_bench", dict(mode="compat", max_events=1536), 80, 8),
)

# One run: only what every checkout of the port has had since its native
# decode was ported, so that an older root runs it too.
CHILD = r"""
import json, sys
import numpy as np
import torch
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.utils.timing import cuda_ms
cases, decodes = json.loads(sys.argv[1])
out = {}
for name, kw, rounds, tiles in cases:
    c = ReaderConfig(**kw)
    tr = synthesize_inventory(c, [Tag.with_id(27, seed=7)], n_rounds=rounds, seed=2)
    x2 = to_planar(np.concatenate([tr.iq] * tiles)).to("cuda")
    st, _ = decode_capture_planar(x2, c)
    ms = cuda_ms(lambda: decode_capture_planar(x2, c), decodes)
    out[name] = {"ms": ms, "epcs": int(st.n_epc_correct), "n": int(x2.shape[1])}
print(json.dumps(out))
"""


def order(blocks: int):
    """The sides of the runs: ``blocks`` times before, after, after, before."""
    return ["before", "after", "after", "before"] * blocks


def card() -> str:
    """``name, power.limit`` of the card as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def run_once(root: Path, decodes: int) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, json.dumps([CASES, decodes])],
                         cwd=str(root), capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"the run in {root} failed: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def summarize(sides, runs) -> dict:
    """{case: {"before": [ms...], "after": [ms...], "block_diff_ms": [...],
    "after_won": k, "blocks": b}} from the runs in the order of ``sides``
    (blocks of four, as ``order`` gives)."""
    out = {}
    for name in runs[0]:
        row = {"before": [], "after": [], "block_diff_ms": []}
        for side, run in zip(sides, runs):
            row[side].append(run[name]["ms"])
        for k in range(0, len(runs), 4):
            block = {s: [] for s in ("before", "after")}
            for side, run in zip(sides[k:k + 4], runs[k:k + 4]):
                block[side].append(run[name]["ms"])
            row["block_diff_ms"].append(statistics.mean(block["after"])
                                        - statistics.mean(block["before"]))
        row["after_won"] = sum(d < 0 for d in row["block_diff_ms"])
        row["blocks"] = len(row["block_diff_ms"])
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--decodes", type=int, default=11)
    args = ap.parse_args(argv)
    sides = order(args.blocks)
    print(json.dumps({"card": card()}), flush=True)
    runs = []
    for k, side in enumerate(sides):
        root = args.before if side == "before" else args.after
        run = run_once(root.resolve(), args.decodes)
        print(json.dumps({"run": k, "side": side, **run}), flush=True)
        runs.append(run)
    for name in runs[0]:
        epcs = {run[name]["epcs"] for run in runs}
        if len(epcs) != 1:
            raise RuntimeError(f"{name}: EPC counts {sorted(epcs)} differ between runs")
    for name, row in summarize(sides, runs).items():
        print(json.dumps({"case": name, "epcs": runs[0][name]["epcs"], **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
