"""The two readings each limit of ``rfidbench/judge.py`` is set between.

    python -m rfidbench.control --workload <cell> --seeds 11 12 13 ...

For each seed it makes the cell's captures as a run does and holds two
decodes of each against the float32 reference (``rfidbench/reference``):
the program's timed entry, ``decode_capture_planar`` (the lower reading:
what sound runs give), and the control, the reference itself with its
front end in bfloat16, the next precision below the float32 the
configurations state (the upper reading: what the comparison must reject);
both references give each slot its verdict by the configuration's
``slot_rule``.
It prints one JSON line a seed with both sets of checks, worst over the
captures.  It needs a card, as a run does; the benchmark's own runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import judge
from .cells import captures, load_cell


def readings(cell, seeds, dev, decode=None):
    """[(seed, program checks, control checks)]; ``decode`` replaces the
    program's entry (the tests' CPU rehearsal)."""
    import torch

    from .reference.decode import decode_capture as reference_decode
    from .run import program

    _, scfg, entry = program(cell, dev)
    decode = decode or entry
    out = []
    for seed in seeds:
        caps = captures(cell, scfg, seed, dev)
        prog, ctl, misses = [], [], 0
        with torch.no_grad():
            for cap in caps:
                got = decode(cap.x2)
                misses += int(got[0].n_epc_correct) != cap.epcs
                got = tuple(type(o)(*(t.cpu() for t in o)) for o in got)
                want = reference_decode(cap.x2, scfg, slot_rule=cell.slot_rule)
                low = reference_decode(cap.x2, scfg, front_dtype=torch.bfloat16,
                                       slot_rule=cell.slot_rule)
                prog.append(judge.compare(*got, *want, cap.truth))
                ctl.append(judge.compare(*low, *want, cap.truth))
                del got, want, low
        limits = cell.workload["limits"]
        out.append((seed, judge.checks(prog, misses, limits), judge.checks(ctl, 0, limits)))
        del caps
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("[rfidbench.control] needs a CUDA device", file=sys.stderr)
        return 2
    for seed, prog, ctl in readings(cell, args.seeds, torch.device("cuda", 0)):
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": {k: v["value"] for k, v in prog.items()},
                          "program_correct": judge.passed(prog),
                          "control": {k: v["value"] for k, v in ctl.items()},
                          "control_correct": judge.passed(ctl)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
