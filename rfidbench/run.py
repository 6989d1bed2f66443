"""The port's benchmark: one run of one cell on one card.

    python -m rfidbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``rfidbench/``
and the port, ``gen2_rfid_tpu_torch``.  A run

1. makes the cell's captures from ``--seed`` with its traffic's generator
   (the frozen synthesizer of ``rfidbench/synth``, given the
   configuration's ``synthesizer`` keywords) and puts them on the card as
   planar float32;
2. builds the port's ``ReaderConfig`` from the configuration and workload
   files;
3. warms up: the first decode (which builds or loads the kernels, timed
   apart on standard error), then the rest of ``warmup_decodes``;
4. with ``--trace 0``, runs a closed loop of back-to-back calls of the timed
   entry, ``runtime/inventory.py::decode_capture_planar``, for ``--seconds``,
   the captures in turn, one caller waiting for each decode's EPC count;
   with ``--trace 1``, runs ``trace_decodes`` such calls under
   ``torch.profiler`` instead and reads the cell's per-layer metrics from
   the trace (``rfidbench/metrics``);
5. reads the card's peak memory, frees the program's state, decodes each
   capture with the plain reference (``rfidbench/reference``), its slots by
   the configuration's ``slot_rule``, and holds the last output of each
   capture in the loop against it (``rfidbench/judge``);
6. prints the checks beside their limits as the last lines of standard
   error, and one JSON line on standard output: ``correct``, ``attempted``
   (decodes timed), ``failed`` (those whose EPC count was not the count
   sent), ``metrics``, ``device`` (with ``--trace 1`` also ``busy_s`` and
   ``window_s``), with ``--trace 1`` ``breakdown``, and ``checks`` last.

End-to-end metrics: ``capture_msps``, the ADC samples of every decode of
the window over the window's host seconds; ``decode_p95_ms``, the 95th
percentile of the window's decodes, each from a CUDA event recorded at its
call to one recorded after it returned, so it holds the host's dispatch and
every sync inside the decode; ``setup_s``, the host seconds from this
module's start to the window's.

The process's OpenMP, MKL and OpenBLAS pools are held to one thread: the
load is one caller in one process.

Without a card, with fewer cards than the cell asks for, or with JAX, its
libraries or the JAX package loaded once the window has closed, it prints
no result and exits non-zero.  It never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One caller thread: the numerical libraries' pools are held to one thread
# before they load, which keeps the host's share of a decode steadier.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import judge  # noqa: E402
from .cells import Cell, captures, load_cell, metric_reader, reader_fields  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gen2_rfid_tpu")


def forbidden_modules() -> list:
    """Top-level names, compared whole, of loaded modules the benchmark may
    not load: JAX, its libraries and the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Timer:
    """Each decode's time: CUDA events on the card, the host clock elsewhere
    (the CPU rehearsals of the tests)."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        self.torch = torch

    def start(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, t0) -> float:
        """Milliseconds since ``t0``; call once the decode's result is read."""
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            e.synchronize()
            return t0.elapsed_time(e)
        return (time.perf_counter() - t0) * 1e3


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def program(cell: Cell, dev):
    """(the port's ReaderConfig, the synthesizer's, the timed entry on
    ``dev``) of ``cell``."""
    import torch

    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar

    from .synth.config import ReaderConfig as SynthConfig

    # The contractions stay in float32: TF32 is the caller's to turn off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fields = reader_fields(cell)
    cfg = ReaderConfig(**fields)

    def decode(x2):
        return decode_capture_planar(x2, cfg, device=dev)

    return cfg, SynthConfig(**fields), decode


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev,
        decode: Optional[Callable] = None) -> Optional[Dict]:
    """One run of ``cell`` on ``dev``; the result line's object, or None
    where a forbidden module was loaded.  ``decode`` replaces the timed
    entry (the tests break it underneath to see ``correct`` fail)."""
    import torch

    from .reference.decode import decode_capture as reference_decode
    from .reference.front import front_taps

    cfg, scfg, entry = program(cell, dev)
    decode = decode or entry
    caps = captures(cell, scfg, seed, dev)

    timer = Timer(dev)
    last: Dict[int, tuple] = {}
    counts = {"decodes": 0, "misses": 0, "samples": 0}
    lat = []

    def one(i: int) -> float:
        k = i % len(caps)
        t0 = timer.start()
        out = decode(caps[k].x2)
        got = int(out[0].n_epc_correct)
        ms = timer.stop(t0)
        last[k] = out
        counts["decodes"] += 1
        counts["misses"] += got != caps[k].epcs
        counts["samples"] += caps[k].x2.shape[1]
        return ms

    log(f"[rfidbench] {cell.name}: {len(caps)} captures of {caps[0].x2.shape[1]} samples, "
        f"{caps[0].epcs} EPCs each, on the card {time.perf_counter() - T_START:.4f} s "
        f"after the start")
    t = time.perf_counter()
    one(0)
    log(f"[rfidbench] first decode {time.perf_counter() - t:.4f} s")
    for i in range(1, cell.workload["warmup_decodes"]):
        one(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for k in counts:
        counts[k] = 0
    setup_s = time.perf_counter() - T_START
    i = cell.workload["warmup_decodes"]
    result: Dict = {}
    if trace:
        from .trace import traced

        n = cell.workload["trace_decodes"]
        start = i
        tr = traced(lambda: one(start + counts["decodes"]), n)
        tr.shapes = {"n": caps[0].x2.shape[1], "ny": caps[0].x2.shape[1] // cfg.decim,
                     "taps": front_taps(scfg), "win": cfg.win_length}
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        result["breakdown"] = tr.breakdown()
    else:
        t_window = time.perf_counter()
        while True:
            lat.append(one(i))
            i += 1
            if time.perf_counter() - t_window >= seconds:
                break
        window_s = time.perf_counter() - t_window
        e2e = {"capture_msps": counts["samples"] / window_s / 1e6,
               "decode_p95_ms": float(np.percentile(lat, 95)),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        result_device = {}
        quarters = [float(np.median(q)) for q in np.array_split(np.array(lat), 4) if q.size]
        log(f"[rfidbench] window {window_s:.4f} s, {counts['decodes']} decodes, "
            f"median {float(np.median(lat)):.4f} ms (by quarter {quarters}), "
            f"p95 {e2e['decode_p95_ms']:.4f} ms")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = {k: tuple(type(o)(*(t.cpu() for t in o)) for o in out) for k, out in last.items()}
    last.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with torch.no_grad():
        per_capture = [judge.compare(*kept[k], *reference_decode(
            cap.x2, scfg, slot_rule=cell.slot_rule), cap.truth)
                       for k, cap in enumerate(caps)]
    log(f"[rfidbench] setup {setup_s:.4f} s; reference {time.perf_counter() - t:.4f} s")
    checks = judge.checks(per_capture, counts["misses"], cell.workload["limits"])
    found = forbidden_modules()
    if found:
        log(f"[rfidbench] forbidden modules loaded: {found}")
        return None
    log(f"[rfidbench] card {power_limit()}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {"correct": judge.passed(checks), "attempted": counts["decodes"],
              "failed": counts["misses"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                         "count": cell.entry["chips"], "memory_peak_bytes": peak,
                         **result_device},
              **result, "checks": checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        log(f"[rfidbench] {cell.name} needs {cell.entry['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
