"""The receiver front end's operating envelope under RX impairments, on the port.

    python -m gen2_rfid_tpu_torch.tools.impair_sweep [--device cpu]
        [--quant-bits 8 ...] [--iq-index 2 ...] [--phase-walk 4e-3 ...]
        [--interferer-dbc -20 ...] [--seeds 1 2 3]

Twin of ``tools/impair_sweep.py``.  For each impairment axis (ADC bits, IQ
imbalance, LO phase-noise walk plain and with channel tracking, an
adjacent reader's CW at 250 kHz and at 40 kHz) it decodes a 6-round
single-tag capture at each of three seeds and prints the read fraction:
where exact decode gives way.  The flags narrow each axis (``--iq-index``
indexes the JAX tool's five gain/phase pairs; ``--interferer-dbc`` runs at
both offsets; ``--seeds`` the captures a point); an axis given no values
prints its heading alone.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import ReaderConfig
from ..runtime.inventory import decode_capture
from ..sim.impairments import RxImpairments, apply_rx_impairments
from ..sim.tag import Tag
from ..sim.trace import synthesize_inventory
from .sweep import add_device_flag, sweep_device, wall_time

N_ROUNDS = 6
SEEDS = (1, 2, 3)
QUANT_BITS = (12, 10, 8, 7, 6, 5)
IQ = ((0.2, 1.0), (0.5, 3.0), (1.0, 6.0), (2.0, 10.0), (3.0, 20.0))
PHASE_WALK = (1e-3, 2e-3, 4e-3, 5e-3, 6e-3, 8e-3)
INTERFERER_HZ = ((250e3, "out-of-band"), (40e3, "in-band"))
INTERFERER_DBC = (-40, -30, -25, -20, -15, -10)


def read_frac(cfg, imp, track=False, seeds=SEEDS, *, device=None):
    """Reads of tag 27 over the rounds of one capture a seed, impaired by
    ``imp``; ``track`` decodes with channel tracking."""
    got = tot = 0
    dcfg = dataclasses.replace(cfg, track_channel=True) if track else cfg
    for s in seeds:
        tr = synthesize_inventory(cfg, [Tag.with_id(27, seed=7)],
                                  n_rounds=N_ROUNDS, seed=s)
        iq = apply_rx_impairments(tr.iq, imp, cfg.adc_rate, seed=s + 10)
        stats, _ = decode_capture(iq, dcfg, device=device)
        got += int(stats.tag_reads[27])
        tot += N_ROUNDS
    return got / tot


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    p.add_argument("--quant-bits", nargs="*", type=int, default=list(QUANT_BITS))
    p.add_argument("--iq-index", nargs="*", type=int, choices=range(len(IQ)),
                   default=list(range(len(IQ))))
    p.add_argument("--phase-walk", nargs="*", type=float, default=list(PHASE_WALK))
    p.add_argument("--interferer-dbc", nargs="*", type=int, default=list(INTERFERER_DBC))
    p.add_argument("--seeds", nargs="+", type=int, default=list(SEEDS),
                   help="capture seeds a point (default 1 2 3)")
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    cfg = ReaderConfig(max_events=64)
    seeds = tuple(args.seeds)
    with wall_time("impair_sweep", dev):
        print("# ADC quantization (full_scale 1.5, leak 1.0, backscatter 0.08)")
        for bits in args.quant_bits:
            f = read_frac(cfg, RxImpairments(quant_bits=bits), seeds=seeds, device=dev)
            print(f"quant_bits={bits:2d}  read_frac={f:.2f}", flush=True)
        print("# IQ imbalance (gain dB / phase deg)")
        for g, ph in (IQ[k] for k in args.iq_index):
            imp = RxImpairments(iq_gain_db=g, iq_phase_deg=ph)
            f = read_frac(cfg, imp, seeds=seeds, device=dev)
            print(f"iq {g:.1f}dB/{ph:4.1f}deg (IRR {imp.image_rejection_db:5.1f} dB)"
                  f"  read_frac={f:.2f}", flush=True)
        print("# LO phase noise (rad/sample random walk @ 2 Msps)")
        for s in args.phase_walk:
            fp = read_frac(cfg, RxImpairments(phase_walk_rad=s), seeds=seeds, device=dev)
            ft = read_frac(cfg, RxImpairments(phase_walk_rad=s), track=True,
                           seeds=seeds, device=dev)
            print(f"phase_walk={s:.0e}  plain={fp:.2f}  tracked={ft:.2f}", flush=True)
        print("# Adjacent-reader CW (dBc vs own leak)")
        for hz, tag_ in INTERFERER_HZ:
            for dbc in args.interferer_dbc:
                imp = RxImpairments(interferer_dbc=float(dbc), interferer_hz=hz)
                f = read_frac(cfg, imp, seeds=seeds, device=dev)
                print(f"interferer {dbc:+d} dBc @ {hz/1e3:.0f} kHz ({tag_})"
                      f"  read_frac={f:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
