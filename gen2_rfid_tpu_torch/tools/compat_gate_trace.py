"""Where a compat_gate launch spends its time, tile by tile, on the card.

    python -m gen2_rfid_tpu_torch.tools.compat_gate_trace [--launches 5]

Builds ``csrc/compat_gate.cu`` a second time with ``-DCOMPAT_GATE_TRACE``
(thread 0 of each tile records ``clock64`` at eight points of the kernel,
and the global timer and its SM at the first) into
``build/gen2_rfid_tpu_torch/``, and runs it through the wrapper
(``kernels/compat_gate.py::compat_gate``, the configuration it chooses) at
the shapes ``chip_smoke.py`` times: the bench capture (80 rounds x 8 tiles,
tag 27 seed 7, simulator seed 2), the golden trace, a live window (the
golden trace's first 2,457 samples) and the fm0_16msps capture (10 rounds x
2 at ``ReaderConfig(adc_rate=16e6, decim=1)``), each through gate_front's
full build.  Each traced launch starts after a read of 256 MB (L2 clean,
none of its data there), as ``utils/timing.py::cuda_ms(flush_by="read")``.

The phases between the points: ``loads`` (amp / avg read and compared),
``halo`` (the halo's first below sample, the first below after each
thread's words, one barrier), ``candidates`` (the T1-quiet rises), ``scan``
(the words' descriptors, one scan across the tile; one tile: the first of
its two scans), ``publish`` (the tile's aggregate stored and released; one
tile: its second scan), ``look-back`` (the wait for the predecessors'
statuses and the composition of their aggregates; one tile: nothing) and
``writes`` (each word's outputs from its carry).  Prints, for each shape,
the median and largest cycles of each phase over the tiles of ``--launches``
launches, the median total, and the span in ns from the first tile's start
to the last tile's (global timer), then one JSON line of it all.  The trace
build's times are its own, not the kernel's: compare phases within it.  It
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from ..config import ReaderConfig
from ..kernels import _build
from ..kernels import compat_gate as cg
from ..kernels.gate_front import gate_front_for_cfg
from ..runtime.inventory import to_planar
from ..sim.tag import Tag
from ..sim.trace import golden_trace, synthesize_inventory

PHASES = ("loads", "halo", "candidates", "scan", "publish", "look-back", "writes")
LIVE_N = 2457


def build_traced() -> ctypes.CDLL:
    """The trace build of compat_gate.cu, compiled once per source."""
    src = _build.CSRC / "compat_gate.cu"
    flags = (*_build.NVCC_FLAGS, "-DCOMPAT_GATE_TRACE")
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libcompat_gate_trace-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.nvcc_path(), *flags, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"trace build failed:\n{proc.stdout}{proc.stderr}")
    lib = cg.bind(ctypes.CDLL(str(out)))
    lib.compat_gate_trace.restype = ctypes.c_int
    lib.compat_gate_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


@contextlib.contextmanager
def traced_wrapper(lib: ctypes.CDLL):
    """compat_gate launches the trace build inside the block."""
    kept = cg._lib
    cg._lib = lambda: lib
    try:
        yield
    finally:
        cg._lib = kept


def gate_inputs(cfg: ReaderConfig, iq: np.ndarray, dev):
    """(|y|, its windowed average, the compat gate's arguments) of a capture."""
    _, amp, sums, _ = gate_front_for_cfg(to_planar(iq).to(dev), cfg)
    avg = sums / torch.tensor(float(cfg.win_length), device=dev)
    return amp, avg, (cfg.thresh_fraction, cfg.n_samples_pw // 2, cfg.n_samples_t1,
                      cfg.num_pulses_command)


def shapes(dev) -> dict:
    tag = [Tag.with_id(27, seed=7)]
    c = ReaderConfig(mode="compat", max_events=1536)
    bench = synthesize_inventory(c, tag, n_rounds=80, seed=2).iq
    golden = gate_inputs(c, golden_trace(c).iq, dev)
    c16 = ReaderConfig(adc_rate=16e6, decim=1, max_events=256)
    fm16 = synthesize_inventory(c16, tag, n_rounds=10, seed=2).iq
    return {"bench": gate_inputs(c, np.concatenate([bench] * 8), dev),
            "golden": golden,
            "live": (golden[0][:LIVE_N].contiguous(), golden[1][:LIVE_N].contiguous(),
                     golden[2]),
            "fm0_16msps": gate_inputs(c16, np.concatenate([fm16] * 2), dev)}


def trace_shape(lib, amp, avg, args, launches: int, flush) -> dict:
    """Per-phase cycles over the tiles of ``launches`` traced launches."""
    n = amp.shape[0]
    config = cg.choose_config(n, args[2])
    ntiles = -(-n // cg.config_tile(config))
    rows = np.zeros((ntiles, 10), dtype=np.uint64)
    phases, totals, spans = [], [], []
    want = cg.compat_gate_plain(amp, avg, *args)
    for _ in range(launches):
        flush.sum()
        torch.cuda.synchronize()
        got = cg.compat_gate(amp, avg, *args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError("the trace build differs from the plain version")
        err = lib.compat_gate_trace(rows.ctypes.data, ntiles)
        if err:
            raise RuntimeError(f"reading the trace: CUDA error {err}")
        r = rows.astype(np.int64)
        phases.append(np.diff(r[:, :8], axis=1))
        totals.append(r[:, 7] - r[:, 0])
        spans.append(int(r[:, 8].max() - r[:, 8].min()))
    d, tot = np.concatenate(phases), np.concatenate(totals)
    return {"n": n, "config": "{}x{}".format(*cg.CONFIGS[config]), "tiles": ntiles,
            "cycles_median": {p: float(np.median(d[:, i])) for i, p in enumerate(PHASES)},
            "cycles_max": {p: int(d[:, i].max()) for i, p in enumerate(PHASES)},
            "total_cycles_median": float(np.median(tot)),
            "start_span_ns_median": float(np.median(spans))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compat_gate_trace: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    lib = build_traced()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {}
    with traced_wrapper(lib):
        for label, (amp, avg, args) in shapes(dev).items():
            t = trace_shape(lib, amp, avg, args, opts.launches, flush)
            out[label] = t
            print(f"compat_gate_trace {label} n={t['n']} {t['config']} x {t['tiles']} tiles: "
                  f"cycles a tile, median / max: " + ", ".join(
                      f"{p} {t['cycles_median'][p]:.0f} / {t['cycles_max'][p]}"
                      for p in PHASES) +
                  f"; total {t['total_cycles_median']:.0f}; tiles started over "
                  f"{t['start_span_ns_median']:.0f} ns", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
