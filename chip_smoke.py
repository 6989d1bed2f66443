#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gen2_rfid_tpu_torch/csrc`` with nvcc,
then:

1. holds each kernel against its plain PyTorch version on the card, at the
   bench shape and at ragged sizes (gate_front: every output within 2e-5 of
   the plain version, 0 expected; gate_stack: flags exactly equal);
2. decodes the golden trace on CUDA: 71 queries / round 72 / 70 EPCs /
   1 unique tag / tag 0x1b read 70 times, and the card's decoded events
   equal a CPU run of the port on the same capture;
3. decodes the bench-size capture (80 rounds x 8 tiles, 9.7 M samples,
   max_events=1536): 640 of 640 EPCs, with launch counts showing that the
   decode went through both kernels; times it with CUDA events;
4. times each kernel and its plain version at the bench shape, beside the
   card's memory-bound time for the same bytes;
5. breaks the bench decode down: synchronized host wall time per stage, and
   the device's busy share and time per kernel from ``torch.profiler``.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero on any failure,
without CUDA, and outside a checkout of the repository.  Imports nothing of
JAX or of the JAX package ``gen2_rfid_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and float32 FLOP/s outside
# the tensor cores.  Both kernels are float32 CUDA-core code.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
GATE_FRONT_TOL = 2e-5          # the CPU tests' tolerance against Pallas


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, flush=None, warmup=2, sleep_cycles=2_000_000):
    """Median device time of fn() over reps runs, each bracketed by CUDA
    events, after ``warmup`` untimed runs.  ``flush`` (a large buffer) is
    overwritten before each run so the run starts with a cold L2; a spin
    kernel then holds the stream until the host has queued the run, so host
    launch time does not pad the reading of a function that never waits for
    the device (a decode does wait: its reading is its wall time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_breakdown(x2, cfg, reps=5):
    """Host wall time of each stage of decode_capture_planar, each ended by
    a synchronize (median of reps): what a caller waits for, stage by stage."""
    import torch

    from gen2_rfid_tpu_torch.dsp.gate import gate_detect
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
    from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_for_cfg
    from gen2_rfid_tpu_torch.runtime.inventory import decode_events, replay_inventory

    def run():
        out = {}

        def stage(name, fn):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3
            return r

        y2 = stage("gate_front", lambda: gate_front_for_cfg(x2, cfg)[0])
        y = torch.complex(y2[0], y2[1])
        flags = stage("gate_stack", lambda: gate_stack_for_cfg(y2, cfg))
        ev = stage("gate_detect", lambda: gate_detect(y, cfg, flags))
        dec = stage("decode_events", lambda: decode_events(y, ev, cfg, specialize=True))
        stage("replay_inventory", lambda: replay_inventory(dec, cfg))
        return out

    torch.cuda.synchronize()
    runs = [run() for _ in range(reps)]
    total = 0.0
    for name in runs[0]:
        ms = sorted(r[name] for r in runs)[reps // 2]
        total += ms
        log(f"[stages] {name:17s} {ms:8.3f} ms (host wall, synchronized)")
    log(f"[stages] sum of medians   {total:8.3f} ms")


def device_profile(fn, reps=3, top=12):
    """torch.profiler over reps decodes: device time by kernel, and the
    share of the window's wall time the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Only the device's own rows (kernels, copies, fills): a host operator's
    # row repeats the time of the kernels it launched.
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] {reps} decodes: wall {wall_us / reps / 1e3:.3f} ms/decode, "
        f"device busy {busy_us / reps / 1e3:.3f} ms/decode "
        f"({100 * busy_us / wall_us:.1f}% busy, {100 - 100 * busy_us / wall_us:.1f}% idle)")
    for t, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[profile] {t / reps:9.1f} us/decode {count // reps:5d} calls  {key[:90]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import gen2_rfid_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: run from a checkout of the repository ({err})",
              file=sys.stderr)
        return 2
    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.kernels import _build
    from gen2_rfid_tpu_torch.kernels.gate_front import (
        front_taps, gate_front, gate_front_plain)
    from gen2_rfid_tpu_torch.kernels.gate_stack import (
        gate_stack_flags, gate_stack_plain)
    from gen2_rfid_tpu_torch.runtime.inventory import (
        decode_capture_planar, to_planar)
    from gen2_rfid_tpu_torch.runtime.stats import format_results, unique_tags
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import golden_trace, synthesize_inventory

    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.strip().splitlines():
            log(f"[build:{name}] {line}")

    cfg0 = ReaderConfig()
    decim, taps = cfg0.decim, front_taps(cfg0)
    win, dcw = cfg0.win_length, cfg0.dc_length
    pw_half, nt1, frac = cfg0.n_samples_pw // 2, cfg0.n_samples_t1, cfg0.thresh_fraction

    # ---- the bench-size capture (bench.py's workload) ----
    cfg_b = ReaderConfig(max_events=1536)
    tr_b = synthesize_inventory(cfg_b, [Tag.with_id(27, seed=7)], n_rounds=80, seed=2)
    reps_tile = 8
    x2_b = to_planar(np.concatenate([tr_b.iq] * reps_tile)).to(dev)
    n_b = x2_b.shape[1]
    expected_b = tr_b.expected_epc_pass * reps_tile
    log(f"[bench capture] N={n_b} samples, Ny={n_b // decim}, "
        f"expected EPCs {expected_b}")

    # ---- phase 1: kernels against their plain versions ----
    err_front = 0.0
    err_stack = 0
    rng = np.random.default_rng(1)
    cases = [("bench", x2_b, 512)]
    for n, blk in [(40961, 512), (9999, 64), (10240, 2048), (4099, 512), (7, 512), (3, 512)]:
        x = rng.normal(size=(2, n)).astype(np.float32)
        cases.append((f"noise n={n}", torch.from_numpy(x).to(dev), blk))
    y2_bench = None
    for label, x2, blk in cases:
        got = gate_front(x2, decim, taps, win, dcw, block_y=blk)
        want = gate_front_plain(x2, decim, taps, win, dcw)
        torch.cuda.synchronize()
        diffs = [float((g - w).abs().max()) if g.numel() else 0.0
                 for g, w in zip(got, want)]
        scale = [max(float(w.abs().max()), 1.0) if w.numel() else 1.0 for w in want]
        log(f"[gate_front {label} block={blk}] max|kernel-plain| "
            f"y={diffs[0]:.3g} amp={diffs[1]:.3g} avgsum={diffs[2]:.3g} "
            f"dcsum={diffs[3]:.3g}")
        check(diffs[0] <= GATE_FRONT_TOL and diffs[1] <= GATE_FRONT_TOL
              and diffs[2] <= GATE_FRONT_TOL * scale[2]
              and diffs[3] <= GATE_FRONT_TOL * scale[3],
              f"gate_front disagrees with its plain version on {label}")
        err_front = max(err_front, *diffs)
        if label == "bench":
            y2_bench = got[0]
    stack_cases = [("bench y", y2_bench, 1024)]
    for n, blk in [(40961, 1024), (9999, 256), (10240, 4096), (150, 1024), (1, 1024)]:
        y = rng.normal(size=(2, n)).astype(np.float32)
        stack_cases.append((f"noise n={n}", torch.from_numpy(y).to(dev), blk))
    for label, y2, blk in stack_cases:
        got = gate_stack_flags(y2, win, pw_half, nt1, frac, block=blk)
        want = gate_stack_plain(y2, win, pw_half, nt1, frac)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        log(f"[gate_stack {label} block={blk}] flags differing: {n_bad} of "
            f"{got.numel()}; set bits {int((want != 0).sum())}")
        check(n_bad == 0, f"gate_stack flags differ from the plain version on {label}")
        if got.numel():
            err_stack = max(err_stack, int((got - want).abs().max()))

    # ---- phase 2: the golden trace on CUDA, against a CPU run ----
    cfg_g = ReaderConfig()
    tr_g = golden_trace(cfg_g)
    x2_g = to_planar(tr_g.iq)
    kernels.reset_launches()
    st_g, dec_g = decode_capture_planar(x2_g.to(dev), cfg_g)
    torch.cuda.synchronize()
    golden_launches = dict(kernels.launches)
    log(format_results(st_g))
    log(f"[golden] launches {golden_launches}")
    check(int(st_g.n_queries) == 71 and int(st_g.cur_inventory_round) == 72
          and int(st_g.n_epc_correct) == 70 and unique_tags(st_g) == 1
          and int(st_g.tag_reads[0x1B]) == 70, "golden tuple not reproduced on CUDA")
    check(all(v > 0 for v in golden_launches.values()),
          "golden decode did not launch both kernels")
    st_c, dec_c = decode_capture_planar(x2_g, cfg_g, device="cpu")
    for f in dec_g._fields:
        a, b = getattr(dec_g, f).cpu(), getattr(dec_c, f)
        if a.dtype in (torch.int32, torch.bool):
            check(torch.equal(a, b), f"golden DecodedEvents.{f}: CUDA != CPU")
        else:
            log(f"[golden] DecodedEvents.{f} max|cuda-cpu| = "
                f"{float((a - b).abs().max()):.3g}")
    for f in st_g._fields:
        check(torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)),
              f"golden InventoryStats.{f}: CUDA != CPU")
    log("[golden] CUDA decode == CPU decode on every int/bool field")
    x2_gd = x2_g.to(dev)
    golden_ms = cuda_ms(lambda: decode_capture_planar(x2_gd, cfg_g), 11)
    log(f"[golden] decode {golden_ms:.3f} ms for {x2_g.shape[1]} samples "
        f"({x2_g.shape[1] / golden_ms / 1e3:.1f} Msamples/s)")

    # ---- phase 3: the main path at bench size ----
    kernels.reset_launches()
    st_b, _ = decode_capture_planar(x2_b, cfg_b)
    torch.cuda.synchronize()
    main_launches = dict(kernels.launches)
    log(format_results(st_b))
    log(f"[bench] launches {main_launches}")
    check(int(st_b.n_epc_correct) == expected_b == 640
          and int(st_b.tag_reads[27]) == 640,
          f"bench decode: {int(st_b.n_epc_correct)} EPCs, expected {expected_b}")
    check(all(v > 0 for v in main_launches.values()),
          "bench decode did not launch both kernels")
    bench_ms = cuda_ms(lambda: decode_capture_planar(x2_b, cfg_b), 11)
    log(f"[bench] decode {bench_ms:.3f} ms for {n_b} samples "
        f"({n_b / bench_ms / 1e3:.1f} Msamples/s, "
        f"{expected_b / bench_ms * 1e3:.0f} EPC/s)")

    # ---- phase 4: per-kernel time at the bench shape ----
    ny = n_b // decim
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    front_ms = cuda_ms(lambda: gate_front(x2_b, decim, taps, win, dcw), 20, flush)
    front_plain_ms = cuda_ms(lambda: gate_front_plain(x2_b, decim, taps, win, dcw), 5, flush)
    stack_ms = cuda_ms(lambda: gate_stack_flags(y2_bench, win, pw_half, nt1, frac), 20, flush)
    stack_plain_ms = cuda_ms(lambda: gate_stack_plain(y2_bench, win, pw_half, nt1, frac), 5, flush)
    # Bytes: each input read once, each output written once.  Operations:
    # float adds/multiplies per output (taps, |y|, the window sums; the
    # dyadic levels, the combine, the threshold).
    front_bound, front_by = bound(
        4 * (2 * n_b) + 4 * (6 * ny),
        ny * (2 * taps + 3 + 1 + (win - 1) + 2 * (dcw - 1)))
    nlev = win.bit_length()
    stack_bound, stack_by = bound(
        4 * (2 * ny) + 4 * ny,
        ny * (3 + 1 + (nlev - 1) + (bin(win).count("1") - 1) + 2))
    log(f"[time] gate_front kernel {front_ms:.4f} ms, plain {front_plain_ms:.4f} ms, "
        f"bound {front_bound:.4f} ms ({front_by})")
    log(f"[time] gate_stack kernel {stack_ms:.4f} ms, plain {stack_plain_ms:.4f} ms, "
        f"bound {stack_bound:.4f} ms ({stack_by})")

    # ---- phase 5: where the bench decode's time goes ----
    stage_breakdown(x2_b, cfg_b)
    device_profile(lambda: decode_capture_planar(x2_b, cfg_b))

    kernel_line = {"kernels": [
        {"name": "gate_front", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_front.cu",
         "replaces": "gen2_rfid_tpu/kernels/gate_front.py:88",
         "launches": main_launches["gate_front"], "max_abs_err": err_front,
         "ms": front_ms, "plain_ms": front_plain_ms, "bound_ms": front_bound,
         "bound_by": front_by, "library_ms": None},
        {"name": "gate_stack", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_stack.cu",
         "replaces": "gen2_rfid_tpu/kernels/gate_stack.py:113",
         "launches": main_launches["gate_stack"], "max_abs_err": err_stack,
         "ms": stack_ms, "plain_ms": stack_plain_ms, "bound_ms": stack_bound,
         "bound_by": stack_by, "library_ms": None},
    ]}
    print(json.dumps(kernel_line), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
