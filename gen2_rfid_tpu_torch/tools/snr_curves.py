"""Decode-rate-vs-SNR curves and waterfall positions per mode, on the port.

    python -m gen2_rfid_tpu_torch.tools.snr_curves [--device cpu]
        [--modes fm0_blf40 ...] [--snr 0 4 ...]

Twin of ``tools/snr_curves.py``: FM0 at BLF 40 kHz, Miller-2/4/8 and FM0 at
BLF 160 kHz, each at 11 SNR points (-4 to 16 dB) of 16 rounds, and each
mode's waterfall (the SNR where the EPC rate crosses 0.5) by bisection
from -6 to 16 dB to 0.25 dB.  SNR is per post-matched-filter half-symbol
(FM0) or half-chip (Miller), as ``sim/snr.py`` defines it.  ``--modes`` and
``--snr`` narrow the grid.  Prints the JAX tool's markdown table.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import ReaderConfig
from ..sim.snr import snr_sweep, theory_waterfall_db, waterfall_db
from .sweep import add_device_flag, sweep_device, wall_time

MODES = {
    "fm0_blf40": ReaderConfig(max_events=64),
    "miller2": ReaderConfig(miller_m=2, adc_rate=2e6, decim=2, max_events=64),
    "miller4": ReaderConfig(miller_m=4, adc_rate=4e6, decim=2, max_events=64),
    "miller8": ReaderConfig(miller_m=8, adc_rate=8e6, decim=2, max_events=64),
    "fm0_blf160": ReaderConfig(blf_hz=160e3, adc_rate=2e6, decim=1,
                               max_events=64),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    p.add_argument("--modes", nargs="+", choices=list(MODES), default=list(MODES))
    p.add_argument("--snr", nargs="+", type=float, default=None,
                   help="SNR points in dB (default -4 to 16 in steps of 2)")
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    grid = np.arange(-4.0, 16.1, 2.0) if args.snr is None else np.array(args.snr)
    with wall_time("snr_curves", dev):
        print(f"theory FM0 waterfall: {theory_waterfall_db():.2f} dB "
              "(Q(sqrt(g)) per bit, 128-bit frame)")
        print("| mode | " + " | ".join(f"{s:.0f}" for s in grid) +
              " | waterfall dB |")
        print("|---" * (len(grid) + 2) + "|")
        for name in args.modes:
            cfg = MODES[name]
            pts = snr_sweep(cfg, list(grid), n_rounds=16, device=dev)
            wf = waterfall_db(cfg, lo_db=-6.0, hi_db=16.0, tol_db=0.25, device=dev)
            row = " | ".join(f"{p.epc_rate:.2f}" for p in pts)
            print(f"| {name} | {row} | {wf:.2f} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
