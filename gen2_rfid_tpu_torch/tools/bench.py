"""Flagship decode throughput of the port, in ADC samples a second, on one card.

    python -m gen2_rfid_tpu_torch.tools.bench [--device cpu] [--decodes 20]
        [--rounds R] [--tiles T]

Twin of the root ``bench.py``: ``ReaderConfig(max_events=1536)``, tag 27
(seed 7), an inventory of 80 rounds at seed 2 tiled 8 times (N = 9,704,304
ADC samples, 640 EPCs a decode), decoded by
``runtime/inventory.py::decode_capture_planar`` from a planar capture
already on the device.  ``vs_baseline`` is samples/s over the reference
reader's real-time 2e6 samples/s.  ``--rounds`` and ``--tiles`` narrow the
capture (for CPU runs and smoke tests); such a line says ``"narrowed":
true``.

Timing.  The JAX bench iterates K decodes inside one jit and takes a
difference quotient, because only a device-to-host read synchronizes its
runtime.  The port's decode is eager and reads the host inside itself (the
role tables' overflow check, the replay's closed-form choice), so a loop of
decodes is no single program.  Each decode is timed whole instead:
``time.perf_counter()`` from the call to the host read of its EPC count,
which waits for the device.  The first decode of a workload pays the kernel
build, library set-up and per-configuration tables: it is printed alone as
``first_decode_ms`` and never counted in the median.  Every decode's count
is checked; a wrong count prints ``FATAL`` on standard error and exits 1.

Prints ONE JSON line, its numbers unrounded: the JAX line's ``metric``,
``value`` (the median over
``--decodes`` timed decodes, Msamples/s), ``unit``, ``vs_baseline``,
``epc_per_s`` and ``band`` ([min, max] Msamples/s), and ``device`` (the
card's name, or ``cpu``), ``power_limit_w`` (``nvidia-smi``'s, null on the
CPU), ``decodes``, ``decode_ms`` (the median), ``first_decode_ms``,
``launches`` (each kernel's launches a timed decode), ``epcs`` (EPCs a
decode), ``samples_per_iter`` (N), ``roles`` (the decode's event table
split into RN16-window and EPC-window rows beside the role tables' capacity
``cap_q``, and whether the overflow fallback to the paranoid decode ran),
``peak_mem_bytes`` and ``narrowed``.

The helpers here (``DecodeCase``, ``Workload``, ``measure``,
``throughput_line``, ``bench_line``) serve ``bench_configs`` and ``bench_scaling`` too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import ReaderConfig
from ..runtime.inventory import (
    ROLE_SLACK, command_roles, decode_capture_planar, to_planar)
from ..sim.tag import Tag
from ..sim.trace import synthesize_inventory
from .sweep import add_device_flag, sweep_device

BASELINE_SPS = 2e6   # the reference reader's real-time budget, samples/s

# (tag id, seed, backscatter); None keeps Tag's default backscatter.
TagSpec = Tuple[int, int, Optional[complex]]


def make_tags(specs: Tuple[TagSpec, ...]) -> List[Tag]:
    """Fresh tags (each draws its RN16s from its own generator)."""
    return [Tag.with_id(tid, seed=seed, **({} if bs is None else {"backscatter": bs}))
            for tid, seed, bs in specs]


@dataclasses.dataclass(frozen=True)
class DecodeCase:
    """A single-channel capture: ``n_rounds`` of the tags' inventory
    synthesized at ``seed`` under ``cfg``, tiled ``tiles`` times."""

    cfg: ReaderConfig
    tags: Tuple[TagSpec, ...]
    n_rounds: int
    seed: int
    tiles: int

    def capture(self) -> Tuple[np.ndarray, int]:
        """(complex64 capture, EPCs a decode must read)."""
        tr = synthesize_inventory(self.cfg, make_tags(self.tags), n_rounds=self.n_rounds,
                                  seed=self.seed)
        return np.concatenate([tr.iq] * self.tiles), tr.expected_epc_pass * self.tiles

    def workload(self, dev: torch.device) -> "Workload":
        iq, epcs = self.capture()
        cfg = self.cfg
        return Workload(to_planar(iq).to(dev),
                        lambda x2: decode_capture_planar(x2, cfg, device=dev), (epcs,))


FLAGSHIP = DecodeCase(ReaderConfig(max_events=1536), ((27, 7, None),), n_rounds=80, seed=2,
                      tiles=8)


def narrowed(case, rounds: Optional[int], tiles: Optional[int]):
    """``case`` with its rounds and tiles replaced where given."""
    return dataclasses.replace(case, n_rounds=rounds or case.n_rounds,
                               tiles=tiles or case.tiles)


class Workload(NamedTuple):
    """A capture on the device, the decode to time on it (``x2`` ->
    (InventoryStats, DecodedEvents)), and the EPCs each decode must read, one
    count a channel."""

    x2: torch.Tensor
    decode: Callable
    epcs: Tuple[int, ...]


class CountMismatch(Exception):
    pass


class Timing(NamedTuple):
    first_s: float
    seconds: List[float]          # each timed decode's
    launches: Dict[str, float]    # each kernel's launches a timed decode
    last: tuple                   # the last decode's (stats, decoded events)


def _launch_counts() -> Dict[str, int]:
    return {"gate_front": kernels.launches["gate_front"],
            "gate_stack_stream": kernels.stack_bodies["stream"],
            "gate_stack_segment": kernels.stack_bodies["segment"],
            "gate_scan": kernels.launches["gate_scan"]}


def measure(w: Workload, decodes: int, label: str) -> Timing:
    """Time ``decodes`` decodes of ``w`` whole, after one untimed first
    decode; each ends at the host read of its EPC counts, and a count other
    than ``w.epcs`` raises ``CountMismatch``."""
    dev = w.x2.device

    def one():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = w.decode(w.x2)
        got = tuple(out[0].n_epc_correct.reshape(-1).tolist())   # waits for the device
        seconds = time.perf_counter() - t0
        if got != w.epcs:
            raise CountMismatch(f"{label} decode mismatch {got} != {w.epcs}")
        return seconds, out

    first, out = one()
    before = _launch_counts()
    seconds = []
    for _ in range(decodes):
        s, out = one()
        seconds.append(s)
    after = _launch_counts()
    return Timing(first, seconds, {k: (after[k] - before[k]) / decodes for k in after}, out)


def role_split(dec, cfg: ReaderConfig) -> Dict:
    """How a single-channel decode's event table fills its role tables
    (``runtime/inventory.py::decode_events``): RN16-window (Query-like) and
    EPC-window (ACK) rows beside ``cap_q`` rows each, and whether either
    overflowed, so that the decode fell back to the paranoid one."""
    cap = dec.index.shape[-1]
    cap_q = min(cap, cap // 2 + 1 + ROLE_SLACK)
    role_q, role_a = command_roles(dec.cmd_type, dec.valid)
    n_q, n_a = int(role_q.sum()), int(role_a.sum())
    return {"valid_rows": int(dec.valid.sum()), "cap": cap, "query_rows": n_q,
            "ack_rows": n_a, "cap_q": cap_q,
            "fallback": cap_q != cap and cfg.mode != "compat" and max(n_q, n_a) > cap_q}


def card(dev: torch.device) -> Tuple[str, Optional[float]]:
    """The device's name (``cpu`` on the host) and its power limit in W
    from ``nvidia-smi`` (None on the host or where it cannot be read)."""
    if dev.type != "cuda":
        return "cpu", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        limit = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        limit = None
    return torch.cuda.get_device_name(dev), limit


def reset_peak(dev: torch.device) -> None:
    """Start the peak from what is allocated now (call it once CUDA is in
    use: before, the allocator knows no device)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def throughput_line(metric: str, n: int, t: Timing, epcs: int, dev: torch.device) -> Dict:
    """The JAX bench line's keys from ``t`` (unrounded), then the device,
    the timing and the launches."""
    per = float(np.median(t.seconds))
    name, limit = card(dev)
    return {
        "metric": metric,
        "value": n / per / 1e6,
        "unit": "Msamples/s/chip",
        "vs_baseline": n / per / BASELINE_SPS,
        "epc_per_s": epcs / per,
        "band": [n / max(t.seconds) / 1e6, n / min(t.seconds) / 1e6],
        "device": name,
        "power_limit_w": limit,
        "decodes": len(t.seconds),
        "decode_ms": per * 1e3,
        "first_decode_ms": t.first_s * 1e3,
        "launches": t.launches,
        "epcs": epcs,
        "samples_per_iter": int(n),
    }


def bench_line(metric: str, case, decodes: int, dev: torch.device, is_narrowed: bool
               ) -> Dict:
    """One case's line: its capture put on the device, then timed by
    ``measure``; a single-channel case adds its role split, a multi-channel
    one its EPCs by channel."""
    w = case.workload(dev)
    reset_peak(dev)
    t = measure(w, decodes, metric)
    line = throughput_line(metric, w.x2.shape[-1], t, sum(w.epcs), dev)
    if isinstance(case, DecodeCase):
        line["roles"] = role_split(t.last[1], case.cfg)
    else:
        line["epcs_by_channel"] = list(w.epcs)
    line.update(peak_mem_bytes=peak_bytes(dev), narrowed=is_narrowed)
    return line


def positive(text: str) -> int:
    """An argparse type: an integer of at least 1."""
    n = int(text)
    if n < 1:
        raise argparse.ArgumentTypeError(f"{text} is not a positive integer")
    return n


def add_bench_flags(p: argparse.ArgumentParser) -> None:
    add_device_flag(p)
    p.add_argument("--decodes", type=positive, default=20,
                   help="timed decodes a workload, after one untimed first decode")
    p.add_argument("--rounds", type=positive, default=None,
                   help="narrow: inventory rounds of every synthesized capture")
    p.add_argument("--tiles", type=positive, default=None,
                   help="narrow: times every capture is tiled")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_bench_flags(p)
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    case = narrowed(FLAGSHIP, args.rounds, args.tiles)
    try:
        line = bench_line("iq_decode_throughput", case, args.decodes, dev, case != FLAGSHIP)
    except CountMismatch as err:
        print(f"FATAL: {err}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
