"""The Miller robustness matrix, on the port.

    python -m gen2_rfid_tpu_torch.tools.miller_robustness_sweep [--device cpu]
        [--m 2 4 8] [--blf-off -0.04 0.04] [--interferer off on] [--cfo off on]

Twin of ``tools/miller_robustness_sweep.py``: the 24 cells

    M in {2, 4, 8}            (adc/decim keeping >=5 samples/chip)
    BLF offset in {-4%, +4%}  (the grid edge)
    interferer in {off, -20 dBc CW at the FM0 link frequency}
    CFO in {0, 300 Hz with channel tracking}

each a 3-round single-tag inventory decoded exactly or not.  Expected
failures: the M=2 + interferer cells, whose 40 kHz subcarrier coincides
with the interferer tone.  M=8 at 8 Msps, decim 2, runs ``gate_stack``'s
segment kernel.  The flags narrow the grid.  Prints the JAX tool's JSON
line a cell and its summary line.
"""

from __future__ import annotations

import argparse
import json

from ..config import ReaderConfig
from ..runtime.inventory import decode_capture
from ..sim.impairments import RxImpairments, apply_rx_impairments
from ..sim.tag import Tag
from ..sim.trace import synthesize_inventory
from .sweep import add_device_flag, sweep_device, wall_time

GEOM = {2: (2e6, 2), 4: (4e6, 2), 8: (8e6, 2)}
N_ROUNDS = 3
_ON = {"off": False, "on": True}


def cell(m: int, off: float, interf: bool, cfo: bool, *, device=None) -> dict:
    """One cell's record: the tag's reads and whether all rounds read."""
    adc, decim = GEOM[m]
    cfg = ReaderConfig(miller_m=m, adc_rate=adc, decim=decim, max_events=64,
                       track_channel=cfo)
    tag = Tag.with_id(27, seed=7, blf_offset=off, cfo_hz=300.0 if cfo else 0.0)
    tr = synthesize_inventory(cfg, [tag], n_rounds=N_ROUNDS, seed=1)
    iq = tr.iq
    if interf:
        imp = RxImpairments(interferer_dbc=-20.0, interferer_hz=40e3)
        iq = apply_rx_impairments(iq, imp, cfg.adc_rate, seed=7)
    stats, _ = decode_capture(iq, cfg, device=device)
    reads = int(stats.tag_reads[27])
    return {"m": m, "blf_off": off, "interferer": interf, "cfo_tracked": cfo,
            "reads": reads, "exact": reads == N_ROUNDS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    p.add_argument("--m", nargs="+", type=int, choices=sorted(GEOM), default=sorted(GEOM))
    p.add_argument("--blf-off", nargs="+", type=float, default=[-0.04, 0.04])
    p.add_argument("--interferer", nargs="+", choices=list(_ON), default=list(_ON))
    p.add_argument("--cfo", nargs="+", choices=list(_ON), default=list(_ON))
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    total = exact = 0
    with wall_time("miller_robustness_sweep", dev):
        for m in args.m:
            for off in args.blf_off:
                for interf in (_ON[k] for k in args.interferer):
                    for cfo in (_ON[k] for k in args.cfo):
                        rec = cell(m, off, interf, cfo, device=dev)
                        total += 1
                        exact += rec["exact"]
                        print(json.dumps(rec), flush=True)
        print(json.dumps({"summary": f"{exact}/{total} exact"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
