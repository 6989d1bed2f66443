"""Multi-process decode of a capture on this host, with the processes'
agreement checked: the command line over ``shard/launch.py::run_local``.

    python -m gen2_rfid_tpu_torch.tools.run_distributed CAPTURE \\
        --num-processes 2 --shards-per-process 4 [--device cuda] \\
        [--expect-json '{"n_epc_correct": 6, ...}']

Prints one JSON line (the record every process agreed on) and exits
non-zero if a process fails or disagrees, or the record misses
``--expect-json``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..shard.launch import run_local


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trace")
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--shards-per-process", type=int, default=4)
    p.add_argument("--device", default="cuda", help="device each process decodes on")
    p.add_argument("--events-per-shard", type=int, default=64)
    p.add_argument("--max-events", type=int, default=256)
    p.add_argument("--expect-json", default=None,
                   help="JSON dict of stats keys that must match exactly")
    args = p.parse_args(argv)

    rec = run_local(args.trace, args.num_processes, args.shards_per_process, args.device,
                    args.events_per_shard, args.max_events)
    print(json.dumps(rec, sort_keys=True))
    if args.expect_json:
        want = json.loads(args.expect_json)
        bad = {k: (rec.get(k), v) for k, v in want.items() if rec.get(k) != v}
        if bad:
            print(f"MISMATCH vs expectation: {bad}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
