"""One process of the multi-process decode of a capture file.

PyTorch counterpart of ``gen2_rfid_tpu/shard/distributed_worker.py``.  Run
as ``python -m gen2_rfid_tpu_torch.shard.distributed_worker`` once per
process (``shard/launch.py::run_local`` starts N of them on this host).
Each process

1. joins the gloo process group (``init_distributed``),
2. decodes its own time shards of the capture file on its device through
   ``decode_file_distributed`` (CUDA unless ``--device`` says otherwise),
3. writes one JSON line of the stats that every process holds after the
   tables' all-gather: the launcher checks that all processes agree.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trace", help="capture file (reference byte format)")
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="device this process decodes on (cuda, cuda:1, cpu)")
    p.add_argument("--shards-per-process", type=int, default=1,
                   help="time shards (virtual shards) this process decodes")
    p.add_argument("--events-per-shard", type=int, default=64)
    p.add_argument("--max-events", type=int, default=256)
    p.add_argument("--out", default=None, help="write stats JSON here")
    args = p.parse_args(argv)

    import numpy as np
    import torch.distributed as dist

    from ..config import ReaderConfig
    from ..runtime.stats import InventoryStats, unique_tags
    from .distributed import decode_file_distributed, init_distributed, stats_to_host

    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes, process_id=args.process_id)
    try:
        cfg = ReaderConfig(max_events=args.max_events)
        stats, _ = decode_file_distributed(
            args.trace, cfg, events_per_shard=args.events_per_shard, device=args.device,
            shards_per_process=args.shards_per_process)
        host = stats_to_host(stats)
        world, rank = ((dist.get_world_size(), dist.get_rank()) if dist.is_initialized()
                       else (1, 0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    reads = host.tag_reads[0]
    nz = np.nonzero(reads)[0]
    rec = {
        "process_id": rank,
        "num_processes": world,
        "n_devices": world * args.shards_per_process,
        "n_queries": int(host.n_queries[0]),
        "n_epc_correct": int(host.n_epc_correct[0]),
        "round": int(host.cur_inventory_round[0]),
        "unique_tags": unique_tags(InventoryStats(*(f[0] for f in host))),
        "tag_reads": {int(t): int(reads[t]) for t in nz},
    }
    line = json.dumps(rec, sort_keys=True)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
