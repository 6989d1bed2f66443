"""Multi-process decode of a capture file on this host.

PyTorch counterpart of ``gen2_rfid_tpu/shard/launch.py``: starts N worker
processes (``python -m gen2_rfid_tpu_torch.shard.distributed_worker``), each
its own interpreter, joined in a gloo process group through a coordinator
on a free localhost port, each decoding ``shards_per_process`` time shards
on ``device``.  The result must equal the single-process decode of the
same capture.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env() -> Dict[str, str]:
    """Worker environment: the package importable from this checkout, and
    one intra-op thread a process (a worker's host ops are small, and N
    workers share the host's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_local(path: str, num_processes: int, shards_per_process: int, device: str,
              events_per_shard: int = 64, max_events: int = 256,
              timeout: float = 600.0) -> dict:
    """Decode the capture with ``num_processes`` local workers and return the
    stats record they all agreed on.  Raises when a worker fails or the
    workers disagree, and after ``timeout`` seconds; every worker is ended
    before it returns or raises."""
    port = free_port()
    procs, outs = [], []
    try:
        for pid in range(num_processes):
            out = tempfile.TemporaryFile(mode="w+")
            outs.append(out)
            cmd = [sys.executable, "-m", "gen2_rfid_tpu_torch.shard.distributed_worker", path,
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(num_processes), "--process-id", str(pid),
                   "--device", device, "--shards-per-process", str(shards_per_process),
                   "--events-per-shard", str(events_per_shard),
                   "--max-events", str(max_events)]
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=worker_env(), stdout=out,
                                          stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        while any(pr.poll() is None for pr in procs):
            for pid, pr in enumerate(procs):
                if pr.poll() not in (None, 0):
                    raise RuntimeError(f"process {pid} exited {pr.returncode}:\n"
                                       f"{_tail(outs[pid])}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the workers did not finish in {timeout} s")
            time.sleep(0.05)
        records = []
        for pid, pr in enumerate(procs):
            if pr.returncode != 0:
                raise RuntimeError(f"process {pid} exited {pr.returncode}:\n{_tail(outs[pid])}")
            lines = [ln for ln in _tail(outs[pid], None).splitlines() if ln.startswith("{")]
            if not lines:
                raise RuntimeError(f"process {pid} printed no record:\n{_tail(outs[pid])}")
            records.append(json.loads(lines[-1]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        for out in outs:
            out.close()
    base = {k: v for k, v in records[0].items() if k != "process_id"}
    for r in records[1:]:
        other = {k: v for k, v in r.items() if k != "process_id"}
        if other != base:
            raise RuntimeError(f"process disagreement:\n{base}\n{other}")
    return base


def _tail(out, n: int = 2000) -> str:
    out.seek(0)
    text = out.read()
    return text if n is None else text[-n:]
