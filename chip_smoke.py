#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gen2_rfid_tpu_torch/csrc`` with nvcc,
then:

0. holds the probe kernel (``x * 2 + 1``) against its plain version, bit for
   bit, before anything else;
1. holds each front kernel against its plain PyTorch version on the card:
   gate_front's full build bit for bit at the bench shape, on noise and at
   every ragged end of its register blocking (ny % R = 1..R-1, ny < R, ny
   below the halo) for three blockings, and on an input 4 bytes past a
   16-byte boundary; its y build bit for bit against its plain version and
   the full build's y at the same kinds of input (ny % 8 = 1..7, ny < 8)
   and at eight other decimations and filter lengths; gate_stack's flags exactly equal on the bench y, noise, every
   input its CPU models are held to (``kernels/gate_stack.py::stream_cases``
   and ``segment_cases``: edge lengths, run and segment boundaries, ties,
   tiny and infinite samples; the Miller, blf640, 160 kHz, Tari 6.25 us,
   Miller-8 320 kHz and 8 and 16 Msps FM0 widths, which run its segment
   kernel) and bench-size lengths on a run boundary and one past it, after
   the stream's fast root and division are held to the IEEE ones on every
   float of their range;
2. decodes the golden trace on CUDA: 71 queries / round 72 / 70 EPCs /
   1 unique tag / tag 0x1b read 70 times, and the card's decoded events
   equal a CPU run of the port on the same capture;
3. decodes the bench-size capture (80 rounds x 8 tiles, 9.7 M samples,
   max_events=1536): 640 of 640 EPCs, with launch counts showing that the
   decode went through both front kernels (gate_front's y build) and one
   gate_pulses launch (one a native gate, in every phase that counts);
   times it with CUDA events.  Every phase that counts launches also counts gate_front's
   by build (``kernels.front_bodies``): native decodes, MRC, recovery, live
   native windows, stream chunks and native shards take the y build,
   compat mode and the exact gate the full build.  From phase 2 to phase 18
   the kernels keep a copy of their first input at each shape and geometry
   (``kernels.keep_inputs``), and after each phase gate_front's two builds,
   gate_stack, compat_gate and gate_pulses are held bit for bit against
   their plain versions on every one of them (``hold_kept``); phases 19 and
   20 do the same each;
4. sweeps gate_front's tile (block_y outputs) and gate_stack's run (words a
   warp streams, at the bench and golden shapes) and prints the fastest,
   then times each kernel and its plain version at the bench shape, beside
   the card's memory-bound time for the same bytes, and gate_front once
   more with a dc window of 47, which runs the kernel built with runtime
   loop bounds (ReaderConfig's widths compile as constants); gate_stack
   also with its data left in L2 (no flush); its segment kernel at the
   blf640 widths on a bench-size capture, checked there at every swept
   segment, with its launch shape and a segment sweep; gate_front's y build
   at the bench shape (its tile swept) and the golden shape beside its
   bound, its plain version and ``torch.nn.functional.conv1d`` with a ones
   kernel (the library call that computes the same y); gate_pulses at the
   bench shape and at the benchmark cell's Ny (46.6 M) beside its byte
   bound and its plain version, bit-equal to the plain version at each.
   Every kernel is timed under both flushes of ``utils/timing.py::cuda_ms``:
   written (L2 left full of dirty lines, the earlier yardstick) and read (L2
   left clean); the kernels line gives the written times in ``ms``,
   ``plain_ms`` and ``library_ms`` and the read ones in ``ms_read``,
   ``plain_ms_read`` and ``library_ms_read``;
5. breaks the bench decode down: synchronized host wall time per stage, and
   the device's busy share and time per kernel from ``torch.profiler``;
6. compat mode: the golden tuple on CUDA, its int/bool fields equal to a CPU
   run, and the bench capture 640/640, each through one launch of
   gate_front's full build and one of compat_gate (no gate_stack); the
   golden trace streamed in 200,000-sample chunks (equal to the batch
   decode), the bench capture at n_time 8 (equal to its single decode) and
   a 3-round live loop (equal to its CPU run), each gate through one
   compat_gate launch; compat_gate bit-equal to its plain version at
   golden (also 4 bytes past a 16-byte boundary), bench, fm0_16msps
   (gate_front's full build of phase 16's capture) and every input of
   ``kernels/compat_gate.py::compat_cases`` at tiles 32, 33 and its model's
   default, every configuration on a drawn input past 1,024 of its tiles,
   200 launches on a drawn input of the bench length the same bits, its
   tile model equal to it at golden and bench; compat_gate timed at bench,
   golden, a live window and fm0_16msps beside its bound, its plain version
   and one ``torch.cummax`` of an int32 row, one device op a call by the
   profiler, its configurations swept at each shape and on both sides of
   the wrapper's cuts (bench prefixes, FM0 at 4 and 8 Msps); the bench decode with
   the kernel and with the plain chain swapped in, in turns, timed and
   profiled;
7. ``exact_gate=True``: the gate-scan kernel against its plain version
   (golden |y| and average, the bench shape, noise, dense edges at lengths
   that are not multiples of 32 or 1024, ties, random runs, and synthetic
   pulse trains with known triggers), golden stats equal to the default
   gate's in both modes, the bench decode 640/640 through gate_scan, timed;
   the kernel timed at the bench shape and on bench-size dense edges, with
   the walk's step counts from its Python model;
8. the golden trace with ``epc_softfix=8``, ``track_channel=True``,
   ``cancel_cw=1`` and ``cancel_cw=2``, each CUDA == CPU on the int fields;
   the first three keep the tuple, ``cancel_cw=2`` loses every EPC as the
   JAX package does (its second tone is the tag's own line); then the bench
   capture with all three switches, 640/640; launch counts for each of
   these decodes show gate_front and gate_stack ran and gate_scan did not;
9. the gate-sums tool (``gen2_rfid_tpu_torch.tools.gate_sums_experiment``)
   at its size: its three sum timings and errors, the pulse-count scans,
   and the probe; then the probe's, an empty launch's and the library
   call's times;
10. Miller-M: at each of bench_configs.py's Miller geometries (miller4,
    miller2, miller8_trext, 6.5-8.4 M samples) gate_front bit for bit
    against its plain version; the full-size decode, 480 / 400 / 120 EPCs,
    through one launch of each (gate_scan none), timed and profiled; the
    kernels timed at each shape beside their bounds (gate_front's y build
    beside its plain version and conv1d, its tile swept at miller4; the
    full build beside its plain version), gate_stack's segment
    kernel checked at each swept segment, with its shape and the sweep
    (miller4 also its plain version); five small Miller
    captures and the pinned ``miller4_impaired`` SigMF fixture (5 queries,
    round 6, 5 EPCs of tag 77), CUDA == CPU on every int/bool field;
11. wideband: bench_configs.py's 16 Msps, 8-channel capture channelized on
    the card against the CPU (5e-6 of the largest output), each channel
    decoded (tags 27 and 99 on channels 1 and 6, nothing elsewhere; one
    gate_front and one gate_stack a channel), the flat
    ``decode_events_multi`` equal to the per-channel decode and
    ``replay_inventory_batch`` to the per-channel stats; timed;
12. stream: the golden trace in 200,000-sample chunks equal to the batch
    decode (two kernel launches a chunk), the bench capture 640 / 640 at the
    default 2,000,000-sample chunk, and a mid-stream checkpoint resumed in a
    fresh decoder to equal stats; timed;
13. antenna-diversity MRC, cell mrc4: a 4-antenna lambda/4 array at a 25
    degree bearing, 80 rounds a channel tiled 8 times (4 x 9.7 M samples),
    decoded through exactly one gate_front launch a channel and no other
    kernel, 640 / 640 EPCs of tag 27, the bearing from the per-antenna
    phases within 1 degree; a two-channel scene CUDA == CPU; timed and
    profiled;
14. EPC-window SIC, cell sic2: two same-seed tags at 80 rounds tiled 8
    times; the decode reads the JAX package's 640 EPCs and
    ``recover_epc_collisions`` its 632 second frames, each in the ground
    truth, through one gate_front launch; nothing on the single-tag bench
    capture; the 4-round scene CUDA == CPU; recovery timed beside the
    decode, with the device time of its cuBLAS contractions;
15. the CLI (``gen2_rfid_tpu_torch.apps.reader``) on the card: ``golden``
    then ``decode`` as ``python -m`` in a child process (the golden tuple);
    the bench-size capture written to a file and run through ``main`` in
    this process: ``decode --max-events 1536`` (640 / 640 through one
    gate_front and one gate_stack launch), ``--chunked`` (the same report,
    one launch of each a chunk), ``--report`` (640 records),
    ``--exact-gate`` (one gate_scan launch), each timed as a whole command
    and, where it calls ``decode_capture``, that call alone, beside the
    file read and the host-to-device copy timed alone; mrc4 under
    ``--mrc --antenna-pos`` (640 / 640, bearing within 1 degree), sic2
    under ``--epc-sic`` (640 read, 632 of tag 0x77 recovered), wideband8
    under ``--wideband 8`` (phase 11's counts), ``range`` over three hop
    captures equal to ``--device cpu`` to 1 mm, ``txspec``, and the native
    C++ engine (host) on the golden trace;
16. FM0 at 8 and 16 Msps, decim 1 (W 2000 and 4000, 20 and 10 rounds
    tiled twice): gate_front at its fitted tile bit for bit, the decode
    through exactly one launch of each front kernel, every EPC of tag 27,
    equal to the CPU decode on every int/bool field, timed and profiled;
    the kernels timed beside their bounds (gate_front's two builds with
    their plain versions, the y build's tile swept, conv1d), the segment
    kernel with its shape and sweep;
16b. compat mode and the exact gate at the seven geometries of phases 10,
    16 and 20 (Miller-4 at decim 1, Miller-2, Miller-8 TRext, BLF 640 and
    160 kHz, FM0 at 8 and 16 Msps) at full size: the compat, exact native
    and exact compat decodes, each through one launch of gate_front's full
    build and one of compat_gate or gate_scan (no gate_stack), reading
    ``GEOMETRY_EPCS`` (compat reads none at BLF 640 and 160 kHz, as the JAX
    package does), each exact-gate decode's stats equal to the default
    gate's in its mode, each timed, profiled and its peak memory read; the
    three decodes of each geometry's 3-round capture equal to the CPU's
    (at 8 Msps in compat mode but for the window products of the padding
    rows: ROADMAP.md section 3, item 12); gate_scan (with its walk's
    steps), compat_gate (with its configurations swept) and, at blf640 and
    blf160, gate_front's full build, each bit-equal to its plain version at
    the geometry's shape and timed beside its bound; the phase's wall time;
17. the closed-loop live reader (``runtime/live.py::LiveReader``): portal24,
    tests/test_population.py's 24-tag session inventory (backlog Q, SIC,
    A/B targets, 40 round commands), with the JAX package's counts (277
    queries, 96 EPCs, 3 target flips, every tag read 4 times), exactly one
    gate_front and one gate_stack launch a window decode, its block shapes,
    slot latency and a profile of its first slots (device ops, host syncs
    and busy share a slot, the channel's host synthesis); the EPC-window
    SIC pair, the link ladder under a -20 dBc interferer and a TAM1 scene,
    each equal to the port's CPU run on every integer field of LiveStats;
    ``python -m gen2_rfid_tpu_torch.apps.reader live --rounds 3 --tags 27 9
    --sic`` in a child process; both front kernels (gate_front's two
    builds) bit-equal to their plain versions at every live shape of
    portal24 and the ladder, and timed there beside their bounds;
18. the time- and channel-sharded decode (``shard/``): the bench capture
    padded to a multiple of 8 x decim at n_time 1, 2 and 8 on positions of
    the card, longcap (the bench trace tiled 32 times, 38.8 M samples) and
    full-size miller4 and blf640 at 8, each through exactly n_time launches
    of each front kernel, with each shard's gate count beside its table's
    capacity, stats in every field and owned trigger indices equal to the
    single decode, timed beside it and the bench n_time 8 decode profiled;
    both front kernels (gate_front's two builds) bit-equal to their plain
    versions on every block and timed at a bench shard's extended shape;
    wideband8 through
    ``decode_wideband_sharded`` on a 2 time x 2 chan mesh (phase 11's
    counts, one gate_front and one gate_stack a time shard and channel);
    the bench capture as a file through ``shard/launch.py::run_local``, two
    CUDA worker processes of four shards each, their agreed record equal to
    the single decode's, timed beside a bare process start;
    ``dryrun_multichip(8)``;
19. the envelope sweeps (``gen2_rfid_tpu_torch/tools/``): the softfix
    false-accept campaign whole (200,000 frames a mode at seed 0, batches of
    4,096), native and compat, equal to the JAX tool's counts (8 and 104
    in 200,704 frames); one row of each other twin (FM0's SNR row and
    waterfall, the RN16 SIC sweep at ratio 0.1, the EPC one at 0.15, the
    classifier at noise 0.064, all 24 Miller cells, one point on each
    impairment axis, 2- and 3-hop ranging), each printed table equal to
    the port's CPU run of the same points (a child process run meanwhile;
    ranging's cm to one unit of their last digit), the Miller matrix
    failing exactly its four M=2 + interferer cells, every decode through
    exactly one gate_front and one gate_stack launch, both kernels then
    bit-equal to their plain versions on every input shape the rows
    launched them on, each sweep's wall time printed;
20. the bench twins (``gen2_rfid_tpu_torch/tools/bench*.py``) at full size,
    a few timed decodes each: the flagship (640 EPCs a decode at N =
    9,704,304), each of the eight configuration cases through its own
    ``main`` (multitag_q4 152, miller4 480, miller2 400, miller8_trext 120,
    blf640 260, blf160 400, wideband8 54 + 54, longcap 2,560) and the
    scaling harness at 8 positions of the card (320 at n_time 1 and 8);
    every line printed, naming the card and its power limit, every decode
    through exactly one gate_front and (native single-channel) one
    gate_stack launch, one of each a channel in wideband8 and a position in
    the sharded decode; both kernels bit-equal to their plain versions on
    every input each run launched them on, multitag_q4's and blf160's
    among them; gate_front's y build timed on blf640's and blf160's.

Prints a ``{"kernels": [...]}`` line: ``gate_front`` is the full build
(its launches the compat bench decode's and, under ``launches_exact``, the
exact gate's, and phase 16b's under ``launches_geometry_modes``; its
Miller, 8 / 16 Msps, live and shard shapes with their times, blf640's and
blf160's under ``geometry_modes``), ``gate_front_y`` the y build (its
launches the native bench decode's; every native shape's row under
``shapes``; its launches in mrc4, sic2's recovery, the CLI's decode,
portal24, the bench n_time 8 sharded decode and phases 19 and 20; its live shapes' rows, each with its time at
the fitting tile and at one tile an SM under ``tiles``, and the same at
the stream's chunk shapes under ``stream_tiles``); gate_stack's entry
carries its launches in the CLI's decode under ``launches_cli``, in
portal24 under ``launches_live`` and its live shapes' rows under
``live_shapes``, in the bench n_time 8 sharded decode under
``launches_sharded`` and its time at its shard shape under
``sharded_shape``, and its launches in phase 19's decodes under
``launches_sweeps`` and in phase 20's under ``launches_bench`` (the
stream kernel there, the segment kernel under ``gate_stack_segment``);
``gate_stack_segment``, gate_stack's segment kernel, its rows at blf640, the
Miller shapes and 8 and 16 Msps under ``shapes``); ``gate_scan`` (its
launches the exact bench decode's, the CLI's and phase 16b's, its rows at
the seven geometries under ``shapes``); ``compat_gate`` (its
launches the compat bench decode's, its stream, shard, live and phase 16b
launches, its ``design``, ``kernels_a_call``, ``tile`` and ``config`` at
bench, its bench, golden, live-window, fm0_16msps and phase 16b rows under
``shapes`` and its configuration sweep under ``sweep``, the compat bench
decode's ms and profile with the plain chain and with the kernel), the
card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure,
without CUDA, and outside a checkout of the repository.  Imports nothing of
JAX or of the JAX package ``gen2_rfid_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bytes/s and float32 FLOP/s outside
# the tensor cores.  Both kernels are float32 CUDA-core code.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Queries, final round, EPCs, unique tags, reads of tag 0x1b: the reference
# README's golden tuple.
GOLDEN = (71, 72, 70, 1, 70)
# The bench capture (bench.py's workload): 80 rounds of tag 27 seed 7 at
# simulator seed 2, tiled 8 times.
BENCH_ROUNDS, BENCH_TILES = 80, 8


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


def golden_tuple(st):
    from gen2_rfid_tpu_torch.runtime.stats import unique_tags

    return (int(st.n_queries), int(st.cur_inventory_round), int(st.n_epc_correct),
            unique_tags(st), int(st.tag_reads[0x1B]))


# What a decode reads from an event's window; the other fields of
# DecodedEvents come from the gate.
WINDOW_PRODUCTS = ("rn16_bits", "epc_bits", "epc_pass", "tag_id", "t_half", "h_est",
                   "slot_state", "rn16_energy", "rn16_margin")


def same_as_cpu(label, cuda_run, cpu_run, invalid_rows=True):
    """Every int/bool field of a CUDA decode's DecodedEvents and
    InventoryStats equals the CPU decode's; the float fields' largest
    differences are logged.  With ``invalid_rows=False`` the window
    products of the invalid rows (padding: the capture's last 8-sample row
    repeated) are left out of the comparison and the invalid rows where they
    differ are counted: ROADMAP.md section 3, item 12."""
    import torch

    (st_g, dec_g), (st_c, dec_c) = cuda_run, cpu_run
    valid = dec_c.valid
    apart = torch.zeros_like(valid)
    for f in dec_g._fields:
        a, b = getattr(dec_g, f).cpu(), getattr(dec_c, f)
        if not invalid_rows and f in WINDOW_PRODUCTS:
            differ = (a != b).reshape(a.shape[0], -1).any(1)
            apart |= differ & ~valid
            a, b = a[valid], b[valid]
        if a.dtype in (torch.int32, torch.bool):
            check(torch.equal(a, b), f"{label} DecodedEvents.{f}: CUDA != CPU")
        else:
            log(f"[{label}] DecodedEvents.{f} max|cuda-cpu| = "
                f"{float((a - b).abs().max()) if a.numel() else 0.0:.3g}")
    for f in st_g._fields:
        check(torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)),
              f"{label} InventoryStats.{f}: CUDA != CPU")
    if invalid_rows:
        log(f"[{label}] CUDA decode == CPU decode on every int/bool field")
    else:
        log(f"[{label}] CUDA decode == CPU decode on every int/bool field but the window "
            f"products of invalid rows: {int(apart.sum())} of {int((~valid).sum())} invalid "
            f"rows decode apart (ROADMAP.md section 3, item 12)")


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_breakdown(x2, cfg, reps=5, label="stages"):
    """Host wall time of each stage of decode_capture_planar, each ended by
    a synchronize (median of reps): what a caller waits for, stage by stage."""
    import torch

    from gen2_rfid_tpu_torch.dsp.gate import gate_detect
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_y_for_cfg
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

        y2 = stage("gate_front_y", lambda: gate_front_y_for_cfg(x2, cfg))
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
        log(f"[{label}] {name:17s} {ms:8.3f} ms (host wall, synchronized)")
    log(f"[{label}] sum of medians   {total:8.3f} ms")


def device_profile(fn, reps=3, top=12, label="profile", unit="decode", summary=None):
    """torch.profiler over reps decodes (or calls of ``unit``): device time
    by kernel, the share of the window's wall time the device was busy, and
    the device ops (kernels, copies, fills) a decode.  Returns the rows (device us over
    the reps, calls, name); fills ``summary``, where given, with the wall and
    busy ms a ``unit``, the busy share, the device ops and the largest device
    work (us a ``unit``, calls, name)."""
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
        log(f"[{label}] the profiler recorded no device time")
        return rows
    n_ops = sum(r[1] for r in rows) // reps
    log(f"[{label}] {reps} {unit}s: wall {wall_us / reps / 1e3:.3f} ms/{unit}, "
        f"device busy {busy_us / reps / 1e3:.3f} ms/{unit} "
        f"({100 * busy_us / wall_us:.1f}% busy, {100 - 100 * busy_us / wall_us:.1f}% idle), "
        f"{n_ops} device ops/{unit}")
    for t, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[{label}] {t / reps:9.1f} us/{unit} {count // reps:5d} calls  {key[:90]}")
    if summary is not None:
        t, count, key = max(rows)
        summary.update(wall_ms=wall_us / reps / 1e3, busy_ms=busy_us / reps / 1e3,
                       busy_share=busy_us / wall_us, device_ops=n_ops,
                       largest=[t / reps, count // reps, key[:90]])
    return rows


def front_bound(n, ny, taps, win, dcw):
    """gate_front's least time: (2, N) in; y2, amp, avgsum, dcsum2 out (6 Ny
    floats); float operations per output (taps, |y|, the window sums)."""
    return bound(4 * (2 * n) + 4 * (6 * ny),
                 ny * (2 * taps + 3 + 1 + (win - 1) + 2 * (dcw - 1)))


def front_y_bound(n, ny, taps):
    """gate_front's y build's least time: (2, N) in, y2 (2, Ny) out; 2T adds
    an output."""
    return bound(4 * (2 * n) + 4 * (2 * ny), ny * 2 * taps)


def launch_counts():
    """The kernels' launch counts, gate_front's also by build: ``front_y``
    (y alone) and ``front_full`` (y, |y| and both windowed sums)."""
    from gen2_rfid_tpu_torch import kernels

    return {**kernels.launches, **{f"front_{k}": v for k, v in kernels.front_bodies.items()}}


def counts_of(gate_front=0, gate_stack=0, gate_scan=0, probe=0, build="y", compat_gate=0,
              gate_pulses=None):
    """The ``launch_counts()`` of a run whose gate_front launches are all of
    one build.  ``gate_pulses`` (one a native gate) is by default one a
    gate_stack launch, whose flags each feed one native gate."""
    return {"gate_front": gate_front, "gate_stack": gate_stack, "gate_scan": gate_scan,
            "compat_gate": compat_gate, "probe": probe,
            "gate_pulses": gate_stack if gate_pulses is None else gate_pulses,
            "front_full": gate_front * (build == "full"), "front_y": gate_front * (build == "y")}


def compat_counts(n):
    """The launches of n compat gates, each after a front end: one of
    gate_front's full build and one of compat_gate a gate."""
    return counts_of(n, build="full", compat_gate=n)


# gate_front's y build: the tiles swept at the shapes that pass ``sweep``
# to y_report (those whose two slabs fit a block's shared memory).
Y_TILES = (256, 512, 1024, 2048, 4096)


def y_report(label, x2, geo, both, fmt, full_y=None, reps=20, plain=True, sweep=None):
    """gate_front's y build at one shape: bit-equal to its plain version and
    to the full build's y (``full_y``, or a launch of the full build), timed
    under both flushes beside its bound, its plain version and the library
    call that computes the same y in another order
    (``torch.nn.functional.conv1d`` with a ones kernel, stride decim, TF32
    off); with ``sweep`` (the flush buffer), its tile swept under the read
    flush.  Returns the row for the kernels line."""
    import torch

    from gen2_rfid_tpu_torch.kernels.gate_front import (
        LIB, SMEM_LIMIT, gate_front, gate_front_y, gate_front_y_plain, y_block_y)
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    decim, taps = geo[:2]
    n = x2.shape[1]
    got = gate_front_y(x2, decim, taps)
    want = gate_front_y_plain(x2, decim, taps)
    if full_y is None:
        full_y = gate_front(x2, *geo)[0]
    ones = torch.ones((1, 1, taps), dtype=torch.float32, device=x2.device)

    def library():
        return torch.nn.functional.conv1d(x2[:, None, :], ones, stride=decim,
                                          padding=taps - 1)

    lib_y = library()[:, 0, :got.shape[1]]
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{label}: gate_front_y is not bit-equal to its plain version")
    check(torch.equal(got, full_y), f"{label}: gate_front_y is not bit-equal to the full "
                                    f"build's y")
    ny = got.shape[1]
    lib_err = float((lib_y - got).abs().max() / got.abs().max()) if ny else 0.0
    t = both(lambda: gate_front_y(x2, decim, taps), reps)
    lt = both(library, reps)
    b, by = front_y_bound(n, ny, taps)
    row = {"n": n, "ny": ny, "decim": decim, "taps": taps,
           "block_y": y_block_y(decim, taps, ny, x2.device),
           "ms": t["write"], "ms_read": t["read"], "bound_ms": b, "bound_by": by,
           "share_read": b / t["read"], "library_ms": lt["write"],
           "library_ms_read": lt["read"], "conv1d_max_rel_diff": lib_err}
    text = ""
    if plain:
        pt = both(lambda: gate_front_y_plain(x2, decim, taps), 3)
        row.update(plain_ms=pt["write"], plain_ms_read=pt["read"])
        text = f", plain {fmt(pt)}"
    if sweep is not None:
        tiles = [b for b in Y_TILES if LIB.gate_front_y_smem_bytes(decim, taps, b) <= SMEM_LIMIT]
        for tile in tiles:
            check(torch.equal(gate_front_y(x2, decim, taps, block_y=tile), want),
                  f"{label}: gate_front_y at block_y={tile} is not bit-equal to its plain version")
        row["sweep_read"] = {
            str(tile): cuda_ms(lambda tile=tile: gate_front_y(x2, decim, taps, block_y=tile),
                               reps, sweep, flush_by="read") for tile in tiles}
        text += "; tile sweep (read) " + ", ".join(f"{k}: {v:.4f}"
                                                  for k, v in row["sweep_read"].items())
    log(f"[time] {label} gate_front_y N={n} Ny={ny} (decim {decim}, taps {taps}, block_y "
        f"{row['block_y']}): {fmt(t)}, bound {b:.6f} ms ({by}), {100 * b / t['read']:.1f}% of "
        f"the read time{text}; conv1d {fmt(lt)} (max |conv1d - y| / max |y| = {lib_err:.3g}); "
        f"bit-equal to plain and to the full build's y")
    return row


def full_row(label, x2, geo, both, fmt, reps=20):
    """gate_front's full build (compat mode and the exact gate) at one shape:
    its time under both flushes beside its bound and its plain version's.
    Returns the row for the kernels line."""
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front, gate_front_plain

    n, ny = x2.shape[1], x2.shape[1] // geo[0]
    t = both(lambda: gate_front(x2, *geo), reps)
    pt = both(lambda: gate_front_plain(x2, *geo), 3)
    b, by = front_bound(n, ny, *geo[1:])
    log(f"[time] {label} gate_front full build N={n} (decim, taps, win, dc) {geo}: {fmt(t)}, "
        f"bound {b:.4f} ms ({by}), {100 * b / t['read']:.1f}% of the read time; plain "
        f"{fmt(pt)}")
    return {"n": n, "ny": ny, "ms": t["write"], "ms_read": t["read"], "bound_ms": b,
            "bound_by": by, "plain_ms": pt["write"], "plain_ms_read": pt["read"]}


def stack_bound(ny, win):
    """gate_stack's least time: (2, Ny) in, Ny flags out; operations per
    output (|y|, the dyadic levels, the combine, the threshold)."""
    return bound(4 * (2 * ny) + 4 * ny,
                 ny * (3 + 1 + (win.bit_length() - 1) + (bin(win).count("1") - 1) + 2))


def pulses_bound(ny, bsz):
    """gate_pulses' least time: the int32 flags read once; the two int32
    block outputs and the two counts written once."""
    from gen2_rfid_tpu_torch.kernels.gate_pulses import block_step

    return bound(4 * ny + 8 * -(-ny // block_step(bsz)) + 8, 0)


def pulses_row(label, flags, cfg, both, fmt, reps=20):
    """gate_pulses at one shape: bit-equal to its plain version, timed under
    both flushes beside its bound and its plain version.  Returns the row
    for the kernels line."""
    import torch

    from gen2_rfid_tpu_torch.dsp.gate import block_size, gate_pulses_plain, pulse_window
    from gen2_rfid_tpu_torch.kernels.gate_pulses import gate_pulses, tile_geometry

    nt1 = cfg.n_samples_t1
    geo = (nt1, cfg.num_pulses_command, block_size(nt1), pulse_window(cfg))
    n = flags.shape[0]
    want = gate_pulses_plain(flags, *geo)
    check(all(torch.equal(g, v) for g, v in zip(gate_pulses(flags, *geo), want)),
          f"{label}: gate_pulses is not bit-equal to its plain version")
    halo, tile, wpt, smem = tile_geometry(geo[3], geo[2])
    t = both(lambda: gate_pulses(flags, *geo), reps)
    pt = both(lambda: gate_pulses_plain(flags, *geo), 3)
    b, by = pulses_bound(n, geo[2])
    log(f"[time] {label} gate_pulses Ny={n} (window {geo[3]}, block {geo[2]}; tile {tile} + "
        f"halo {halo}, {wpt} words a thread, {smem} B shared): {fmt(t)}, bound {b:.4f} ms "
        f"({by}), {100 * b / t['read']:.1f}% of the read time; plain {fmt(pt)}; "
        f"{int(want[2][0])} triggers; bit-equal to plain")
    return {"n": n, "window": geo[3], "bsz": geo[2], "tile": tile, "halo": halo, "wpt": wpt,
            "ms": t["write"], "ms_read": t["read"], "bound_ms": b, "bound_by": by,
            "share_read": b / t["read"], "plain_ms": pt["write"], "plain_ms_read": pt["read"],
            "triggers": int(want[2][0])}


def segment_report(label, y2, geo, both, fmt, flush, plain=False):
    """gate_stack's segment kernel at one shape: its flags against the plain
    version's at the automatic segment and at each swept one, its launch
    shape (the shared memory against the Python mirror's), its time under
    both flushes beside the bound, and the segment sweep under the read
    flush.  Returns the row for the kernels line."""
    from gen2_rfid_tpu_torch.kernels.gate_stack import (
        gate_stack_flags, gate_stack_plain, gate_stack_shape, segment_smem_bytes)
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    ny = y2.shape[1]
    shp = gate_stack_shape(ny, *geo[:3])
    check(shp["smem_bytes"] == segment_smem_bytes(*geo[:3]),
          f"{label}: the segment kernel's shared memory is not the Python mirror's")
    auto = shp["run"]
    runs = sorted({max(auto // 4, 1), max(auto // 2, 1), auto, 2 * auto, 4 * auto, 64, 256})
    want = gate_stack_plain(y2, *geo)
    err = 0
    for run in [0] + runs:
        got = gate_stack_flags(y2, *geo, run=run)
        check(int((got != want).sum()) == 0,
              f"{label}: segment kernel flags differ from plain at run={run}")
        err = max(err, int((got - want).abs().max()))
    waves = shp["grid"] / (shp["blocks_per_sm"] * shp["sms"])
    log(f"[gate_stack segment] {label} Ny={ny} widths {geo[:3]}: flags == plain at run 0 and "
        f"{runs}; shape {shp}, {waves:.2f} waves")
    t = both(lambda: gate_stack_flags(y2, *geo), 20)
    sweep = {r: cuda_ms(lambda r=r: gate_stack_flags(y2, *geo, run=r), 20, flush, flush_by="read")
             for r in runs}
    b, by = stack_bound(ny, geo[0])
    log(f"[gate_stack segment sweep] {label}: " + ", ".join(
        f"run={r}: {v:.4f}" for r, v in sweep.items()) + f" ms (read flush); automatic run={auto}, "
        f"fastest run={min(sweep, key=sweep.get)}")
    row = {"ms": t["write"], "ms_read": t["read"], "bound_ms": b, "bound_by": by,
           "share_read": b / t["read"], "run": auto, "max_abs_err": err,
           "smem_bytes": shp["smem_bytes"], "blocks_per_sm": shp["blocks_per_sm"],
           "grid": shp["grid"],
           "sweep_read": {str(r): v for r, v in sweep.items()}}
    if plain:
        pt = both(lambda: gate_stack_plain(y2, *geo), 5)
        row.update(plain_ms=pt["write"], plain_ms_read=pt["read"])
    log(f"[time] gate_stack segment kernel {label} Ny={ny}: {fmt(t)}, bound {b:.6f} ms ({by}), "
        f"{100 * b / t['read']:.1f}% of the read time" +
        (f"; plain {fmt(pt)}" if plain else ""))
    return row


# FM0 at sample rates where W >= 2000 (8 and 16 Msps at decim 1; tag 27
# seed 7, seed 2, tiled twice): name, config, rounds.  Their Ny is 2.5 M and
# 2.6 M, beside the bench's 1.9 M.
HIGH_RATES = (
    ("fm0_8msps", dict(adc_rate=8e6, decim=1, max_events=256), 20),
    ("fm0_16msps", dict(adc_rate=16e6, decim=1, max_events=256), 10),
)


def phase_high_rates(dev, both, fmt, flush, path_run, tiles=2):
    """Phase 16: FM0 captures at 8 and 16 Msps, decim 1 (W 2000 and 4000),
    decoded on the card through exactly one launch of each front kernel
    (gate_front's y build), every EPC read and equal to the CPU decode,
    timed and profiled; gate_front's full build at its fitted tile
    bit-equal to its plain version and its y build to both; the kernels
    timed beside their bounds (the full build beside its plain version too),
    gate_stack's segment kernel with its shape and sweep.  Returns
    {"segment": {name: row}, "y": {name: row}, "full": {name: row}} and the
    gate_stack launches of the decodes."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.kernels.gate_front import (
        fitting_block_y, front_taps, gate_front, gate_front_plain)
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.runtime.stats import unique_tags
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    rows, launches = {"segment": {}, "y": {}, "full": {}}, 0
    for name, kw, rounds in HIGH_RATES:
        c = ReaderConfig(**kw)
        tr = synthesize_inventory(c, [Tag.with_id(27, seed=7)], n_rounds=rounds, seed=2)
        x2c = to_planar(np.concatenate([tr.iq] * tiles))
        want_epc = tr.expected_epc_pass * tiles
        x2 = x2c.to(dev)
        n = x2.shape[1]
        geo_f = (c.decim, front_taps(c), c.win_length, c.dc_length)
        geo_s = (c.win_length, c.n_samples_pw // 2, c.n_samples_t1, c.thresh_fraction)
        got = gate_front(x2, *geo_f)
        check(all(torch.equal(g, w) for g, w in zip(got, gate_front_plain(x2, *geo_f))),
              f"{name}: gate_front is not bit-equal to its plain version")
        y2 = got[0]
        ny = y2.shape[1]
        log(f"[{name}] N={n}, Ny={ny}; gate_front (decim, taps, win, dc) {geo_f} at block_y="
            f"{fitting_block_y(*geo_f)} bit-equal to plain")
        run, counts = path_run(f"{name} decode", x2, c, once=True)
        st = run[0]
        check(int(st.n_epc_correct) == want_epc and int(st.tag_reads[27]) == want_epc
              and unique_tags(st) == 1,
              f"{name}: {int(st.n_epc_correct)} EPCs, expected {want_epc} of tag 27")
        launches += counts["gate_stack"]
        same_as_cpu(name, run, decode_capture_planar(x2c, c, device="cpu"))
        ms = cuda_ms(lambda: decode_capture_planar(x2, c), 5)
        log(f"[{name}] decode {ms:.3f} ms for {n} samples ({n / ms / 1e3:.1f} Msamples/s), "
            f"{want_epc} / {want_epc} EPCs of tag 27")
        device_profile(lambda: decode_capture_planar(x2, c), reps=2, top=6,
                       label=f"profile {name}")
        rows["y"][name] = dict(y_report(name, x2, geo_f, both, fmt, full_y=y2, sweep=flush),
                               launches=counts["front_y"])
        rows["full"][name] = full_row(name, x2, geo_f, both, fmt)
        rows["segment"][name] = dict(segment_report(name, y2, geo_s, both, fmt, flush),
                                     launches=counts["gate_stack"])
        del x2, y2, got
    return rows, launches


# Phase 16b: compat mode and the exact gate at the seven geometries of phases
# 10, 16 and 20, at full size.  Tag 27's EPCs a decode: compat, exact native,
# exact compat.  Compat keeps the reference's reply windows (2 tag bits of
# slack, a sync search of 1.5 tag bits), which miss every reply at BLF 640
# and 160 kHz, in the JAX package too (ROADMAP.md section 3, item 11).
GEOMETRY_EPCS = {
    "miller4": (480, 480, 480), "miller2": (400, 400, 400),
    "miller8_trext": (120, 120, 120), "blf640": (0, 260, 0), "blf160": (0, 400, 0),
    "fm0_8msps": (40, 40, 40), "fm0_16msps": (20, 20, 20)}
# The three decodes of a geometry: label, mode, exact_gate.
GEOMETRY_DECODES = (("compat", "compat", False), ("exact native", "native", True),
                    ("exact compat", "compat", True))
# The capture each geometry is held to the CPU decode on: 3 rounds, a
# 32-row table.
SMALL_ROUNDS, SMALL_EVENTS = 3, 32
# Where the paranoid decodes (compat mode: every event's window decoded)
# meet padding rows that the card and the CPU decode apart: the preamble
# correlation of the capture's last 8-sample row repeated is 0 at every
# offset but for rounding (ROADMAP.md section 3, item 12).
PADDING_APART = ("fm0_8msps",)


def geometry_cases():
    """{name: DecodeCase} of the seven geometries at full size:
    bench_configs' Miller and BLF cases and phase 16's FM0 captures at 8 and
    16 Msps (tag 27 seed 7, seed 2, tiled)."""
    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.tools.bench import DecodeCase
    from gen2_rfid_tpu_torch.tools.bench_configs import CASES, TAG27

    cases = {name: CASES[name]
             for name in ("miller4", "miller2", "miller8_trext", "blf640", "blf160")}
    for name, kw, rounds in HIGH_RATES:
        cases[name] = DecodeCase(ReaderConfig(**kw), TAG27, n_rounds=rounds, seed=2, tiles=2)
    return cases


def scan_row(label, amp, avg, args, both, fmt):
    """gate_scan at one shape: bit-equal to its plain version (the host
    loop, timed once) and to its Python model, whose walk gives the serial
    steps; timed under both flushes beside its bound (amp and avg in, trig
    and pulses out: 13 bytes a sample; a multiply and two compares).
    Returns the row for the kernels line."""
    import torch

    from gen2_rfid_tpu_torch.kernels.gate_scan import (
        gate_scan, gate_scan_edges_plain, gate_scan_plain)

    n = amp.shape[0]
    got_t, got_p = gate_scan(amp, avg, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_t, want_p = gate_scan_plain(amp, avg, *args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_bad = int((got_t != want_t).sum()) + int((got_p != want_p).sum())
    check(n_bad == 0, f"gate_scan differs from its plain version at {label}: {n_bad} outputs")
    m_t, m_p, steps = gate_scan_edges_plain(amp, avg, *args)
    check(torch.equal(m_t, want_t.cpu()) and torch.equal(m_p, want_p.cpu()),
          f"gate_scan's edge-walk model differs from the plain FSM at {label}")
    t = both(lambda: gate_scan(amp, avg, *args), 5)
    b, by = bound(13 * n, 3 * n)
    log(f"[time] {label} gate_scan n={n}: {fmt(t)} for {steps} serial steps "
        f"({int(want_t.sum())} triggers), bound {b:.6f} ms ({by}), "
        f"{100 * b / t['read']:.2f}% of the read time; plain {plain_ms:.1f} ms (host loop); "
        f"kernel == plain == model")
    return {"n": n, "ms": t["write"], "ms_read": t["read"], "bound_ms": b, "bound_by": by,
            "share_read": b / t["read"], "plain_ms": plain_ms, "steps": steps,
            "triggers": int(want_t.sum())}


def phase_geometry_modes(dev, both, fmt, flush):
    """Phase 16b: compat mode and the exact gate at every geometry the native
    path runs (``geometry_cases``).  At each, at full size: the compat, exact
    native and exact compat decodes on the card, each through one launch of
    gate_front's full build and one of compat_gate or gate_scan (no
    gate_stack, no y build), reading ``GEOMETRY_EPCS`` of tag 27, each
    exact-gate decode's stats equal to the default gate's in its mode; each
    timed, profiled and its peak memory read.  On the geometry's 3-round
    capture the three card decodes equal the CPU decode.  gate_front's full
    build, gate_scan and compat_gate bit-equal to their plain versions at
    the geometry's shape; gate_scan timed with its walk's steps, compat_gate
    by ``compat_row`` with its configurations swept, the full build by
    ``full_row`` at blf640 and blf160 (phases 10 and 16 time it at the
    others).  Returns the rows for the kernels line, the launches of the
    full-size decodes and the configuration sweep; logs the table of
    decodes as one JSON object."""
    import dataclasses

    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.kernels.compat_gate import compat_gate, compat_gate_plain
    from gen2_rfid_tpu_torch.kernels.gate_front import front_taps, gate_front, gate_front_plain
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.runtime.stats import unique_tags
    from gen2_rfid_tpu_torch.tools.bench import narrowed
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    t_phase = time.perf_counter()
    rows = {"gate_scan": {}, "compat_gate": {}, "gate_front": {}}
    launches = {"gate_front": 0, "gate_scan": 0, "compat_gate": 0}
    table, sweep_shapes = {}, {}
    for name, case in geometry_cases().items():
        t_geo = time.perf_counter()
        cfg = case.cfg
        iq, _ = case.capture()
        x2 = to_planar(iq).to(dev)
        del iq
        n = x2.shape[1]
        geo_f = (cfg.decim, front_taps(cfg), cfg.win_length, cfg.dc_length)
        got = gate_front(x2, *geo_f)
        check(all(torch.equal(g, w) for g, w in zip(got, gate_front_plain(x2, *geo_f))),
              f"{name}: gate_front's full build is not bit-equal to its plain version")
        _, amp, avgsum, _ = got
        del got
        avg = avgsum / torch.tensor(float(cfg.win_length), device=dev)
        log(f"[{name} modes] N={n}, Ny={amp.shape[0]}; gate_front full build (decim, taps, "
            f"win, dc) {geo_f} bit-equal to plain")
        default = {"native": decode_capture_planar(x2, cfg)[0]}
        for (label, mode, exact), want_epc in zip(GEOMETRY_DECODES, GEOMETRY_EPCS[name]):
            c = dataclasses.replace(cfg, mode=mode)
            kernels.reset_launches()
            st, _ = decode_capture_planar(x2, c, exact_gate=exact)
            torch.cuda.synchronize()
            got = launch_counts()
            want = counts_of(1, gate_scan=1, build="full") if exact else compat_counts(1)
            log(f"[{name} {label}] launches {got}; {int(st.n_epc_correct)} EPCs, "
                f"{unique_tags(st)} tag(s)")
            check(got == want, f"{name} {label}: launches {got}, expected {want}")
            for k in launches:
                launches[k] += got[k]
            check(int(st.n_epc_correct) == want_epc and int(st.tag_reads[27]) == want_epc
                  and unique_tags(st) == (want_epc > 0),
                  f"{name} {label}: {int(st.n_epc_correct)} EPCs ({int(st.tag_reads[27])} of "
                  f"tag 27, {unique_tags(st)} tags), expected {want_epc} of tag 27")
            if not exact:
                default[mode] = st
            else:
                for f in st._fields:
                    check(torch.equal(getattr(st, f), getattr(default[mode], f)),
                          f"{name} {label}: InventoryStats.{f} != the default gate's")
            ms = cuda_ms(lambda: decode_capture_planar(x2, c, exact_gate=exact), 5)
            prof = {}
            device_profile(lambda: decode_capture_planar(x2, c, exact_gate=exact), reps=2,
                           top=6, label=f"profile {name} {label}", summary=prof)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            decode_capture_planar(x2, c, exact_gate=exact)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log(f"[{name} {label}] decode {ms:.3f} ms for {n} samples "
                f"({n / ms / 1e3:.1f} Msamples/s), {want_epc} EPCs; peak memory "
                f"{peak / 2**20:.1f} MB, {(peak - base) / 2**20:.1f} MB over the "
                f"{base / 2**20:.1f} MB held before it"
                + ("; stats equal to the default gate's" if exact else ""))
            table[f"{name} {label}"] = dict(ms=ms, epcs=want_epc, peak_mb=peak / 2**20,
                                            decode_peak_mb=(peak - base) / 2**20, **prof)
        # The kernels at this shape.
        cfg_c = dataclasses.replace(cfg, mode="compat")
        args_c = (cfg_c.thresh_fraction, cfg_c.n_samples_pw // 2, cfg_c.n_samples_t1,
                  cfg_c.num_pulses_command)
        got = compat_gate(amp, avg, *args_c)
        want = compat_gate_plain(amp, avg, *args_c)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name}: compat_gate is not bit-equal to its plain version")
        args_s = (cfg.thresh_fraction, cfg.n_samples_pw // 2, cfg.n_samples_t1,
                  cfg.num_pulses_command, cfg.rn16_window, cfg.epc_window)
        rows["gate_scan"][name] = dict(scan_row(name, amp, avg, args_s, both, fmt), launches=2)
        if name != "fm0_16msps":         # phase 6 times it there
            rows["compat_gate"][name] = dict(
                compat_row(name, amp, avg, args_c, both, fmt, count_ops=False), launches=1)
            sweep_shapes[name] = (amp, avg, args_c)
        if name in ("blf640", "blf160"):  # phases 10 and 16 time the others
            rows["gate_front"][name] = dict(full_row(name, x2, geo_f, both, fmt), launches=3)

        # The 3-round capture: the three decodes on the card equal the CPU's.
        small = narrowed(dataclasses.replace(case, cfg=dataclasses.replace(
            cfg, max_events=SMALL_EVENTS)), SMALL_ROUNDS, 1)
        x2s = to_planar(small.capture()[0])
        for label, mode, exact in GEOMETRY_DECODES:
            c = dataclasses.replace(small.cfg, mode=mode)
            kernels.reset_launches()
            run = decode_capture_planar(x2s.to(dev), c, exact_gate=exact)
            torch.cuda.synchronize()
            got = launch_counts()
            want = counts_of(1, gate_scan=1, build="full") if exact else compat_counts(1)
            check(got == want, f"{name} {label}, 3 rounds: launches {got}, expected {want}")
            same_as_cpu(f"{name} {label}, 3 rounds", run,
                        decode_capture_planar(x2s, c, exact_gate=exact, device="cpu"),
                        invalid_rows=not (name in PADDING_APART and mode == "compat"))
        del x2, amp, avg, avgsum
        torch.cuda.empty_cache()
        log(f"[{name} modes] {time.perf_counter() - t_geo:.1f} s")
    sweep = compat_sweep(sweep_shapes, both)
    del sweep_shapes
    log(f"[geometry modes table] {json.dumps(table)}")
    log(f"[phase 16b] compat and the exact gate at {len(table) // 3} geometries: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows, launches, sweep


# Full-size Miller captures: bench_configs.py's case_miller4, case_miller2 and
# case_miller8_trext (tag 27 seed 7, 20 rounds, seed 2, tiled): name, config,
# tiles, ADC samples, EPCs.
MILLER_BENCH = (
    ("miller4", dict(miller_m=4, decim=1, max_events=1280), 24, 7_756_944, 480),
    ("miller2", dict(miller_m=2, decim=2, max_events=1024), 20, 6_464_120, 400),
    ("miller8_trext", dict(miller_m=8, trext=1, adc_rate=8e6, decim=2, max_events=640), 6,
     8_393_424, 120),
)
# tests/test_miller.py::test_miller_decode's geometries and one TRext one.
MILLER_SMALL = (
    dict(miller_m=2, adc_rate=2e6, decim=2), dict(miller_m=2, adc_rate=2e6, decim=5),
    dict(miller_m=4, adc_rate=4e6, decim=2), dict(miller_m=8, adc_rate=8e6, decim=2),
    dict(miller_m=4, adc_rate=4e6, decim=2, trext=1),
)


def phase_miller(dev, both, fmt, flush, path_run):
    """Phase 10: the two kernels at each Miller bench geometry against their
    plain versions (gate_front's y build also against the full build's y);
    the full-size decodes through them (the y build), timed and profiled;
    small captures and the pinned SigMF fixture, CUDA against CPU.  Returns
    {kernel: {capture: time and bound}} for the kernels line: gate_front's
    full build and its y build, and gate_stack's segment kernel with its
    shape and sweep."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.io.sigmf import load_sigmf
    from gen2_rfid_tpu_torch.kernels.gate_front import front_taps, gate_front, gate_front_plain
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.runtime.stats import unique_tags
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
    from gen2_rfid_tpu_torch.tools.fixtures import fixture_specs
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    shapes = {"gate_front": {}, "gate_front_y": {}, "gate_stack": {}}
    for name, kw, reps, want_n, want_epc in MILLER_BENCH:
        c = ReaderConfig(**kw)
        tr = synthesize_inventory(c, [Tag.with_id(27, seed=7)], n_rounds=20, seed=2)
        x2 = to_planar(np.concatenate([tr.iq] * reps)).to(dev)
        n = x2.shape[1]
        check(n == want_n and tr.expected_epc_pass * reps == want_epc,
              f"{name}: N={n}, {tr.expected_epc_pass * reps} EPCs, expected {want_n}, {want_epc}")
        geo_f = (c.decim, front_taps(c), c.win_length, c.dc_length)
        geo_s = (c.win_length, c.n_samples_pw // 2, c.n_samples_t1, c.thresh_fraction)
        got = gate_front(x2, *geo_f)
        want = gate_front_plain(x2, *geo_f)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name}: gate_front is not bit-equal to its plain version")
        y2 = got[0]
        ny = y2.shape[1]
        del got, want
        log(f"[{name}] N={n}, Ny={ny}; gate_front (decim, taps, win, dc) {geo_f} bit-equal to "
            f"plain")
        (st, _), counts = path_run(f"{name} bench", x2, c, once=True)
        check(int(st.n_epc_correct) == want_epc and int(st.tag_reads[27]) == want_epc
              and unique_tags(st) == 1,
              f"{name}: {int(st.n_epc_correct)} EPCs, expected {want_epc} of tag 27")
        ms = cuda_ms(lambda: decode_capture_planar(x2, c), 5)
        log(f"[{name}] decode {ms:.3f} ms for {n} samples ({n / ms / 1e3:.1f} Msamples/s, "
            f"{want_epc / ms * 1e3:.0f} EPC/s), {want_epc} / {want_epc} EPCs")
        stage_breakdown(x2, c, label=f"stages {name}")
        device_profile(lambda: decode_capture_planar(x2, c), reps=2, top=8,
                       label=f"profile {name}")
        shapes["gate_front_y"][name] = dict(
            y_report(name, x2, geo_f, both, fmt, full_y=y2, sweep=flush if name == "miller4"
                     else None), launches=counts["front_y"])
        shapes["gate_front"][name] = full_row(name, x2, geo_f, both, fmt)
        shapes["gate_stack"][name] = dict(
            segment_report(name, y2, geo_s, both, fmt, flush, plain=name == "miller4"),
            launches=counts["gate_stack"])
        del x2, y2
        torch.cuda.empty_cache()

    for kw in MILLER_SMALL:
        c = ReaderConfig(max_events=64, **kw)
        tr = synthesize_inventory(c, [Tag.with_id(27, seed=7)], n_rounds=3, seed=1)
        x2 = to_planar(tr.iq)
        label = "miller " + " ".join(f"{k}={v}" for k, v in kw.items())
        run, _ = path_run(label, x2.to(dev), c, once=True)
        check((int(run[0].n_queries), int(run[0].n_epc_correct), int(run[0].tag_reads[27]))
              == (3, 3, 3), f"{label}: not 3 queries and 3 EPCs of tag 27")
        same_as_cpu(label, run, decode_capture_planar(x2, c, device="cpu"))
    c = fixture_specs()["miller4_impaired"]["cfg"]
    iq, _ = load_sigmf(str(REPO / "tests" / "fixtures" / "miller4_impaired"))
    x2 = to_planar(iq)
    run, _ = path_run("miller4_impaired fixture", x2.to(dev), c, once=True)
    got = (int(run[0].n_queries), int(run[0].cur_inventory_round), int(run[0].n_epc_correct),
           unique_tags(run[0]), int(run[0].tag_reads[77]))
    log(f"[miller4_impaired fixture] queries, round, EPCs, unique tags, reads of 77: {got}")
    check(got == (5, 6, 5, 1, 5), "miller4_impaired fixture: not its pinned stats")
    same_as_cpu("miller4_impaired fixture", run, decode_capture_planar(x2, c, device="cpu"))
    return shapes


def phase_wideband(dev, both, fmt):
    """Phase 11: the channelizer on the card against the CPU, the
    per-channel decode's counts, the flat multi-channel decode against the
    per-channel one, timed."""
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.dsp.channelizer import channelize_planar, decode_wideband_planar
    from gen2_rfid_tpu_torch.dsp.gate import GateEvents, gate_detect
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_y_for_cfg
    from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_for_cfg
    from gen2_rfid_tpu_torch.runtime.inventory import (
        decode_events, decode_events_multi, replay_inventory_batch, to_planar)
    from gen2_rfid_tpu_torch.tools.bench_configs import CASES
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    wide, occupied = CASES["wideband8"].capture()
    x2_cpu = to_planar(wide)
    x2 = x2_cpu.to(dev)
    n_chan = 8
    cfg = ReaderConfig(max_events=256)
    ch = channelize_planar(x2, n_chan)
    ch_cpu = channelize_planar(x2_cpu, n_chan)
    err = float((ch.cpu() - ch_cpu).abs().max() / ch_cpu.abs().max())
    log(f"[wideband] N={x2.shape[1]} at 16 Msps, {n_chan} channels of {ch.shape[2]}; "
        f"channelizer max|cuda-cpu| / max|cpu| = {err:.3g}")
    check(err <= 5e-6, f"channelizer on the card differs from the CPU by {err:.3g}")
    kernels.reset_launches()
    res = decode_wideband_planar(x2, n_chan, cfg)
    torch.cuda.synchronize()
    got = launch_counts()
    log(f"[wideband] launches {got}")
    check(got == counts_of(n_chan, n_chan),
          "wideband decode: one gate_front (y build) and one gate_stack a channel, no gate_scan")
    for k in range(n_chan):
        tag, want = occupied.get(k, (0, 0))
        n_ok = int(res[k][0].n_epc_correct)
        log(f"[wideband] channel {k}: {n_ok} EPCs (expected {want})")
        check(n_ok == want and (not want or int(res[k][0].tag_reads[tag]) == want),
              f"wideband channel {k}: {n_ok} EPCs, expected {want}")
    ys, evs = [], []
    for k in range(n_chan):
        y2 = gate_front_y_for_cfg(ch[k], cfg)
        y = torch.complex(y2[0], y2[1])
        ys.append(y)
        evs.append(gate_detect(y, cfg, gate_stack_for_cfg(y2, cfg)))
    y_c = torch.stack(ys)
    ev_c = GateEvents(*(torch.stack(f) for f in zip(*evs)))
    multi = decode_events_multi(y_c, ev_c, cfg)
    for k in range(n_chan):
        one = decode_events(y_c[k], evs[k], cfg, specialize=True, overflow_fallback=False)
        for f in one._fields:
            a = getattr(multi, f)[k]
            if a.dtype in (torch.int32, torch.bool):
                check(torch.equal(a, getattr(one, f)),
                      f"decode_events_multi channel {k} {f} != the channel's decode_events")
    stats_c = replay_inventory_batch(multi, cfg)
    for k in range(n_chan):
        for f in stats_c._fields:
            check(torch.equal(getattr(stats_c, f)[k], getattr(res[k][0], f)),
                  f"replay_inventory_batch channel {k} {f} != the channel's decode")
    log("[wideband] decode_events_multi == per-channel decode_events on every int/bool "
        "field; replay_inventory_batch == per-channel stats")
    chan_t = both(lambda: channelize_planar(x2, n_chan), 10)
    wide_ms = cuda_ms(lambda: decode_wideband_planar(x2, n_chan, cfg), 3)
    multi_ms = cuda_ms(lambda: decode_events_multi(y_c, ev_c, cfg), 3)
    log(f"[time] wideband channelizer {fmt(chan_t)}; whole wideband decode {wide_ms:.3f} ms "
        f"for {x2.shape[1]} samples ({x2.shape[1] / wide_ms / 1e3:.1f} Msamples/s); "
        f"decode_events_multi of the 8 tables {multi_ms:.3f} ms")
    device_profile(lambda: decode_wideband_planar(x2, n_chan, cfg), reps=2, top=8,
                   label="profile wideband")


def phase_stream(cfg_g, tr_g, st_g, iq_b, cfg_b, flush):
    """Phase 12: the golden trace streamed in 200,000-sample chunks equals the
    batch decode; the bench capture at the default chunk reads 640 / 640; a
    checkpoint saved mid-stream resumes in a fresh decoder; each chunk
    launches gate_front (its y build) and gate_stack once.  The y build is
    timed at each chunk shape, kept by ``kernels.keep_inputs`` (which main
    has on through the phase), at the fitting tile and at one tile an SM.
    Returns those rows."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.runtime.stream import StreamDecoder
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    sd = StreamDecoder(cfg_g, chunk_adc=200_000)
    kernels.reset_launches()
    st_s, total = sd.decode(iter(np.array_split(tr_g.iq, 7)))
    torch.cuda.synchronize()
    got = launch_counts()
    log(f"[stream golden] {sd._chunk_no} chunks, launches {got}, tuple {golden_tuple(st_s)}")
    check(got == counts_of(sd._chunk_no, sd._chunk_no),
          "stream: one gate_front (y build) and one gate_stack a chunk, no gate_scan")
    check(total == tr_g.iq.size and golden_tuple(st_s) == GOLDEN,
          "stream: golden tuple not reproduced")
    for f in st_s._fields:
        check(torch.equal(getattr(st_s, f), getattr(st_g, f)),
              f"stream golden InventoryStats.{f} != the batch decode's")
    st_b, _ = StreamDecoder(cfg_b).decode(iter([iq_b]))
    check(int(st_b.n_epc_correct) == 640 and int(st_b.tag_reads[27]) == 640,
          f"stream bench: {int(st_b.n_epc_correct)} EPCs, expected 640")
    ckpt = REPO / "build" / "chip_smoke_stream.npz"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    a = StreamDecoder(cfg_b)
    a.reset()
    a.feed(iq_b[: iq_b.size // 2])
    a.save_checkpoint(str(ckpt))
    b = StreamDecoder(cfg_b)
    b.load_checkpoint(str(ckpt))
    b.feed(iq_b[iq_b.size // 2:])
    st_r, _ = b.finish()
    for f in st_r._fields:
        check(torch.equal(getattr(st_r, f), getattr(st_b, f)),
              f"stream bench resumed from a checkpoint: InventoryStats.{f} differs")
    ckpt.unlink()
    log(f"[stream bench] 640 / 640 EPCs at the default chunk; resumed from a mid-stream "
        f"checkpoint to equal stats")
    chunks = {}
    for key, x in list(kernels.kept.items()):
        if key[0] == "gate_front" and key[2] == "y":
            chunks.setdefault((key[1], key[3], key[4]), x)
    check(chunks, "stream: no chunk input of gate_front's y build was kept")
    tiles = [tile_vs_spread(f"stream chunk N={shape[1]}", x, decim, taps, flush)
             for (shape, decim, taps), x in sorted(chunks.items())]
    ms = cuda_ms(lambda: StreamDecoder(cfg_b).decode(iter([iq_b])), 3)
    log(f"[time] stream decode of the bench capture {ms:.3f} ms for {iq_b.size} samples "
        f"({iq_b.size / ms / 1e3:.1f} Msamples/s)")
    device_profile(lambda: StreamDecoder(cfg_b).decode(iter([iq_b])), reps=2, top=8,
                   label="profile stream")
    return tiles


# mrc4: tests/test_ranging.py::test_aoa_from_diversity_decode's array at full
# size: tag 27 seed 7 on four antennas of a lambda/4 line at a 25 degree
# bearing, 80 rounds a channel, cut to the shortest, tiled 8 times.
MRC_BEARING_DEG = 25.0
# sic2: tests/test_collision.py::test_batch_epc_sic_recovers_second_tags's
# scene at 80 rounds.  The JAX package's counts for one tile, on the CPU:
# 80 EPCs read by the decode (tag 0x41), 79 second frames recovered (tag
# 0x77; the ACK of round 10 keeps only its first frame).
SIC_PRIMARY, SIC_EXTRA = 80, {0x77: 79}


def mrc_array(cfg, n_rounds, theta_deg=MRC_BEARING_DEG):
    """(antenna positions, per-antenna complex captures cut to the
    shortest) of the lambda/4 array."""
    import numpy as np

    from gen2_rfid_tpu_torch.runtime.ranging import C_LIGHT
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    f = cfg.freq_hz
    pos = [k * C_LIGHT / f / 4 for k in range(4)]
    s = np.sin(np.radians(theta_deg))
    chans = []
    for x in pos:
        tag = Tag.with_id(27, seed=7, backscatter=0.08 * np.exp(1j * (0.4 + 2 * np.pi * f * x * s
                                                                      / C_LIGHT)))
        chans.append(synthesize_inventory(cfg, [tag], n_rounds=n_rounds,
                                          seed=int(x * 1e4) + 5).iq)
    n = min(c.size for c in chans)
    return pos, [c[:n] for c in chans]


def mrc_same_as_cpu(label, cuda_run, cpu_run):
    """A diversity decode on the card against the CPU's: every stats field
    and the event table's own fields equal; the decode products equal on
    valid events whose window fits (an invalid event's windows are padding,
    where the period search meets candidates equal but for summation order:
    tests/torch_compare.py); h_chan within 1e-4 of its largest magnitude."""
    import torch

    (st_g, dec_g, h_g), (st_c, dec_c, h_c) = cuda_run, cpu_run
    for f in st_g._fields:
        check(torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)),
              f"{label} InventoryStats.{f}: CUDA != CPU")
    v = dec_c.valid
    rows = {f: v & dec_c.rn16_fits for f in ("rn16_bits", "slot_state")}
    rows.update({f: v & dec_c.epc_fits for f in ("epc_bits", "epc_pass", "tag_id")})
    for f in dec_g._fields:
        a, b = getattr(dec_g, f).cpu(), getattr(dec_c, f)
        if a.dtype in (torch.int32, torch.bool):
            keep = rows.get(f, torch.ones_like(v))
            check(torch.equal(a[keep], b[keep]), f"{label} DecodedEvents.{f}: CUDA != CPU")
    keep = v & dec_c.rn16_fits & dec_c.epc_fits
    err = float((h_g.cpu()[keep] - h_c[keep]).abs().max() / h_c[keep].abs().max())
    check(err <= 1e-4, f"{label} h_chan: CUDA off the CPU by {err:.3g} of its largest")
    log(f"[{label}] CUDA == CPU on every stats and int/bool event field; "
        f"h_chan max|cuda-cpu| / max|cpu| = {err:.3g}")


def phase_mrc(dev, rounds=80, tiles=8):
    """Phase 13, cell mrc4: the 4-antenna diversity decode at full size
    through one gate_front launch (y build) a channel and no other kernel, its
    bearing, CUDA against CPU on a small two-channel scene, timed and
    profiled.  Returns the launch counts and the decode's ms."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch import carry, kernels
    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.runtime.diversity import (
        decode_capture_mrc_full, decode_capture_mrc_planar)
    from gen2_rfid_tpu_torch.runtime.inventory import to_planar
    from gen2_rfid_tpu_torch.runtime.ranging import aoa_from_mrc
    from gen2_rfid_tpu_torch.runtime.stats import unique_tags
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    cfg = ReaderConfig(max_events=1536)
    pos, chans = mrc_array(cfg, rounds)
    x = torch.stack([to_planar(np.concatenate([c] * tiles)) for c in chans]).to(dev)
    n_chan, _, n = x.shape
    log(f"[mrc4] {n_chan} channels x N={n} ({x.numel() * 4 / 1e6:.0f} MB float32), "
        f"max_events={cfg.max_events}")
    kernels.reset_launches()
    st, dec, h = decode_capture_mrc_planar(x, cfg)
    torch.cuda.synchronize()
    got = launch_counts()
    log(f"[mrc4] launches {got}")
    check(got == counts_of(n_chan, gate_pulses=1),
          f"mrc4: {got}, expected one gate_front (y build) a channel, one gate_pulses (the "
          "gate on the combined envelope) and nothing else")
    want = rounds * tiles
    check(int(st.n_epc_correct) == want and int(st.tag_reads[27]) == want
          and unique_tags(st) == 1,
          f"mrc4: {int(st.n_epc_correct)} EPCs, expected {want} of tag 27")
    # runtime/ranging.py is numpy: it takes CPU tensors.
    est = aoa_from_mrc(carry.decoded_from_numpy(carry.decoded_to_numpy(dec)), h.cpu(), pos,
                       cfg.freq_hz)[27]
    log(f"[mrc4] {int(st.n_epc_correct)} / {want} EPCs of tag 27; bearing {est['aoa_deg']:.4f} "
        f"deg (true {MRC_BEARING_DEG}), fit residual {est['resid_rad']:.4f} rad")
    check(abs(est["aoa_deg"] - MRC_BEARING_DEG) < 1.0, "mrc4: bearing off by a degree or more")
    ms = cuda_ms(lambda: decode_capture_mrc_planar(x, cfg), 5)
    log(f"[time] mrc4 decode {ms:.3f} ms for {n_chan} x {n} samples ({n_chan * n / ms / 1e3:.1f} "
        f"Msamples/s over all channels, {want / ms * 1e3:.0f} EPC/s)")
    device_profile(lambda: decode_capture_mrc_planar(x, cfg), reps=2, top=8, label="profile mrc4")
    del x
    torch.cuda.empty_cache()

    small = ReaderConfig(max_events=64)
    iqs = [synthesize_inventory(small, [Tag.with_id(27, seed=7, backscatter=bs)], n_rounds=4,
                                noise=0.004, seed=seed).iq
           for bs, seed in ((0.08 * np.exp(0.4j), 100), (0.08 * np.exp(-1.7j), 200))]
    run_g = decode_capture_mrc_full(iqs, small)
    check(int(run_g[0].n_epc_correct) == 4, "mrc two-channel scene: not 4 EPCs on CUDA")
    mrc_same_as_cpu("mrc two-channel", run_g, decode_capture_mrc_full(iqs, small, device="cpu"))
    return got, ms


def sic_scene(n_rounds):
    """Tags 0x41 and 0x77 with one seed: the same slots and RN16s, so every
    ACK window holds both EPC frames.  (trace, tags)"""
    import numpy as np

    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    rng = np.random.default_rng(31)

    def mk(tid, bs):
        epc = rng.integers(0, 2, 96)
        for k in range(8):
            epc[88 + k] = (tid >> (7 - k)) & 1
        return Tag(epc96=epc, seed=5, backscatter=bs)

    tags = [mk(0x41, 0.09 + 0.02j), mk(0x77, 0.04 - 0.035j)]
    return synthesize_inventory(ReaderConfig(max_events=64), tags, n_rounds=n_rounds, seed=12)


def phase_sic(dev, x2_bench, cfg_bench, tiles=8):
    """Phase 14, cell sic2: EPC-window SIC after the decode of the same-seed
    scene at full size, through one gate_front launch (y build); the JAX package's
    counts, frames from the ground truth, nothing on the single-tag bench
    capture, the small scene CUDA against CPU; timed and profiled.  Returns
    the recovery's launch counts and its ms."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.runtime.inventory import (
        decode_capture, decode_capture_planar, to_planar)
    from gen2_rfid_tpu_torch.runtime.recovery import extra_tag_reads, recover_epc_collisions
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    tr = sic_scene(80)
    truth = {tuple(int(b) for b in fr)
             for e in tr.events if e.kind == "ack" and e.epc_frames for _, fr in e.epc_frames}
    cfg = ReaderConfig(max_events=1536)
    x2 = to_planar(np.concatenate([tr.iq] * tiles)).to(dev)
    st, dec = decode_capture_planar(x2, cfg)
    n_valid = int((dec.valid & dec.epc_fits).sum())
    log(f"[sic2] N={x2.shape[1]}, {n_valid} valid events with an EPC window; decode reads "
        f"{int(st.n_epc_correct)} EPCs (tag 0x41: {int(st.tag_reads[0x41])})")
    check(int(st.n_epc_correct) == SIC_PRIMARY * tiles == int(st.tag_reads[0x41]),
          f"sic2: the decode read {int(st.n_epc_correct)} EPCs, expected {SIC_PRIMARY * tiles}")
    kernels.reset_launches()
    rec = recover_epc_collisions(x2, dec, cfg)
    torch.cuda.synchronize()
    got = launch_counts()
    extra = extra_tag_reads(rec)
    want = {t: c * tiles for t, c in SIC_EXTRA.items()}
    log(f"[sic2] recovery launches {got}; extra reads {extra} (expected {want})")
    check(got == counts_of(1),
          f"sic2 recovery: {got}, expected one gate_front launch (y build) and nothing else")
    check(extra == want, f"sic2: extra reads {extra}, expected {want}")
    check(all(tuple(int(b) for b in fr) in truth for _, _, fr in rec),
          "sic2: a recovered frame is not in the simulator's ground truth")
    decode_ms = cuda_ms(lambda: decode_capture_planar(x2, cfg), 5)
    rec_ms = cuda_ms(lambda: recover_epc_collisions(x2, dec, cfg), 5)
    log(f"[time] sic2 decode {decode_ms:.3f} ms, recovery {rec_ms:.3f} ms over {n_valid} "
        f"windows ({len(rec)} frames recovered)")
    rows = device_profile(lambda: recover_epc_collisions(x2, dec, cfg), reps=2, top=10,
                          label="profile sic2 recovery")
    gemm = [r for r in rows if any(k in r[2].lower() for k in ("gemm", "gemv", "xmma"))]
    solve = [r for r in rows if any(k in r[2].lower() for k in ("getrf", "getrs", "trsm", "lu_"))]
    log(f"[sic2] SIC contractions (cuBLAS gemm and gemv kernels): "
        f"{sum(r[0] for r in gemm) / 2 / 1e3:.3f} ms/recovery in "
        f"{sum(r[1] for r in gemm) // 2} launches; Gram solves "
        f"{sum(r[0] for r in solve) / 2 / 1e3:.3f} ms in {sum(r[1] for r in solve) // 2}")
    del x2, dec
    torch.cuda.empty_cache()

    _, dec_b = decode_capture_planar(x2_bench, cfg_bench)
    none = recover_epc_collisions(x2_bench, dec_b, cfg_bench)
    log(f"[sic2] the single-tag bench capture: {len(none)} frames recovered")
    check(none == [], "recovery found second frames on the single-tag bench capture")

    small = sic_scene(4)
    cfg_s = ReaderConfig(max_events=64)
    runs = []
    for d in ("cuda", "cpu"):
        _, dec_s = decode_capture(small.iq, cfg_s, device=d)
        runs.append(recover_epc_collisions(small.iq, dec_s, cfg_s, device=d))
    check(len(runs[0]) == len(runs[1]) == 4
          and all(a[:2] == b[:2] and np.array_equal(a[2], b[2]) for a, b in zip(*runs)),
          "sic 4-round scene: CUDA recovery != CPU recovery")
    log("[sic 4 rounds] CUDA == CPU on every recovered (event, tag, frame)")
    return got, rec_ms


# Phase 15: the CLI's files go here (inside the checkout, ignored by git).
CLI_DIR = REPO / "build" / "chip_smoke_cli"
HOPS_MHZ = (902.75, 915.25, 927.25)


def cli(argv, reps=1, timed_decode=False):
    """``gen2_rfid_tpu_torch.apps.reader.main(argv)`` in this process with its
    standard output captured, ``reps`` times: (return code, the last run's
    output, the median host wall ms of the whole command, and with
    ``timed_decode`` the median ms of the ``decode_capture`` calls inside
    it, each ended by a synchronize).  The output is logged."""
    import contextlib
    import io

    import torch

    from gen2_rfid_tpu_torch.apps import reader
    from gen2_rfid_tpu_torch.runtime import inventory

    inner = []
    real = inventory.decode_capture

    def decode_capture(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        inner.append((time.perf_counter() - t0) * 1e3)
        return out

    walls = []
    if timed_decode:
        inventory.decode_capture = decode_capture
    try:
        for _ in range(reps):
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = reader.main([str(a) for a in argv])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        inventory.decode_capture = real
    text = buf.getvalue()
    shown = " ".join(Path(a).name if "/" in str(a) else str(a) for a in argv)
    for line in text.strip("\n").splitlines():
        log(f"[cli {shown}] {line}")
    med = sorted(walls)[len(walls) // 2]
    dec_ms = sorted(inner)[len(inner) // 2] if inner else None
    return rc, text, med, dec_ms


def cli_launches(argv, want, label, build="y"):
    """One CLI run with the counts set to 0 just before it and read just
    after; fails unless they are ``want``, every gate_front launch of
    ``build``.  (counts, output)"""
    import torch

    from gen2_rfid_tpu_torch import kernels

    kernels.reset_launches()
    rc, text, _, _ = cli(argv)
    torch.cuda.synchronize()
    got = launch_counts()
    want = counts_of(**want, build=build)
    log(f"[cli {label}] launches {got}")
    check(rc == 0, f"cli {label}: exit {rc}")
    check(got == want, f"cli {label}: launches {got}, expected {want}")
    return got, text


def report_lines(text):
    """The inventory report of a decode's output: its lines but the
    wall-time line."""
    return [ln for ln in text.splitlines() if not ln.startswith("| Decoded ")]


def phase_cli(dev, iq_b, tr_g):
    """Phase 15: the CLI on the card.  The module entry point in a child
    process (golden, then its decode); the bench-size capture through
    ``main`` in process (decode, --chunked, --report, --exact-gate), timed
    with the file read and the host-to-device copy apart; mrc4 under --mrc,
    sic2 under --epc-sic, wideband8 under --wideband 8, range over three hop
    captures against --device cpu, txspec, and the native engine on the
    golden trace.  Returns the bench decode's and the exact gate's launch
    counts."""
    import shutil

    import numpy as np
    import torch

    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.io.tracefile import read_trace, write_trace
    from gen2_rfid_tpu_torch.native import NativeEngine
    from gen2_rfid_tpu_torch.runtime.inventory import to_planar
    from gen2_rfid_tpu_torch.tools.bench_configs import CASES

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    try:
        # The module entry point, as a user starts it.
        gold = CLI_DIR / "golden.bin"
        for argv in (["golden", gold], ["decode", gold]):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "gen2_rfid_tpu_torch.apps.reader",
                                  *map(str, argv)], cwd=str(REPO), capture_output=True,
                                 text=True, timeout=600)
            log(f"[cli python -m {argv[0]}] exit {out.returncode} in "
                f"{time.perf_counter() - t0:.1f} s")
            for line in (out.stdout + out.stderr).strip("\n").splitlines():
                log(f"[cli python -m {argv[0]}] {line}")
            check(out.returncode == 0, f"python -m ... {argv[0]}: exit {out.returncode}")
        lines = out.stdout.splitlines()
        for want in ("| Number of queries/queryreps sent : 71", "| Current Inventory round : 72",
                     "| Correctly decoded EPC : 70", "| Number of unique tags : 1",
                     "| Tag ID : 1b  Num of reads : 70"):
            check(want in lines, f"python -m ... decode golden: no line {want!r}")

        # The bench-size capture: the file read and the copy apart from the decode.
        bench = CLI_DIR / "bench.bin"
        write_trace(str(bench), iq_b)
        log(f"[cli bench] {bench.stat().st_size} bytes, N={iq_b.size}")
        read_ms, copy_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            iq = read_trace(str(bench))
            t1 = time.perf_counter()
            x2 = to_planar(iq).to(dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            read_ms.append((t1 - t0) * 1e3)
            copy_ms.append((t2 - t1) * 1e3)
        del x2
        read_med, copy_med = sorted(read_ms)[1], sorted(copy_ms)[1]
        argv_b = ["decode", bench, "--max-events", "1536"]
        main_launches, text = cli_launches(argv_b, {"gate_front": 1, "gate_stack": 1}, "bench")
        report = report_lines(text)
        for want in ("| Correctly decoded EPC : 640", "| Tag ID : 1b  Num of reads : 640"):
            check(want in report, f"cli bench decode: no line {want!r}")
        _, _, cmd_ms, dec_ms = cli(argv_b, reps=5, timed_decode=True)
        log(f"[cli time] decode bench.bin: command {cmd_ms:.3f} ms (host wall, median of 5), "
            f"decode_capture inside it {dec_ms:.3f} ms; alone: read_trace {read_med:.3f} ms, "
            f"planar + host-to-device copy {copy_med:.3f} ms (median of 3)")
        times = {"decode": (cmd_ms, dec_ms)}

        # The stream decoder's chunks: the full ones, the padded rest and
        # the closing zero chunk, one launch of each front kernel a chunk.
        n_chunks = iq_b.size // 2_000_000 + 2
        _, text = cli_launches(argv_b + ["--chunked"],
                               {"gate_front": n_chunks, "gate_stack": n_chunks}, "bench --chunked")
        check(report_lines(text) == report,
              "cli --chunked: the report differs from the batch decode's")
        _, _, ms, _ = cli(argv_b + ["--chunked"], reps=3)
        times["decode --chunked"] = (ms, None)

        rep_path = CLI_DIR / "bench.jsonl"
        rc, text, ms, dec_ms = cli(argv_b + ["--report", rep_path], reps=3, timed_decode=True)
        recs = [json.loads(ln) for ln in rep_path.read_text().splitlines()]
        check(rc == 0 and f"| Wrote 640 tag-report records to {rep_path}" in text.splitlines()
              and len(recs) == 640 and all(r["tag_id"] == 27 for r in recs),
              f"cli --report: {len(recs)} records, expected 640 of tag 27")
        times["decode --report"] = (ms, dec_ms)

        exact_launches, text = cli_launches(argv_b + ["--exact-gate"],
                                            {"gate_front": 1, "gate_scan": 1}, "bench --exact-gate",
                                            build="full")
        check("| Correctly decoded EPC : 640" in text.splitlines(), "cli --exact-gate: not 640")
        _, _, ms, dec_ms = cli(argv_b + ["--exact-gate"], reps=3, timed_decode=True)
        times["decode --exact-gate"] = (ms, dec_ms)
        bench.unlink()

        # mrc4 under --mrc: 640 / 640 and the bearing.
        cfg = ReaderConfig(max_events=1536)
        pos, chans = mrc_array(cfg, 80)
        ants = []
        for k, c in enumerate(chans):
            ants.append(CLI_DIR / f"ant{k}.bin")
            write_trace(str(ants[k]), np.concatenate([c] * 8))
        del chans
        argv = ["decode", *ants, "--mrc", "--max-events", "1536",
                "--antenna-pos", *[f"{p!r}" for p in pos]]
        _, text = cli_launches(argv, {"gate_front": 4, "gate_pulses": 1}, "mrc4")
        lines = text.splitlines()
        bearing = [ln for ln in lines if ln.startswith("| Tag 0x1b: bearing ")]
        check("| Correctly decoded EPC : 640" in lines and len(bearing) == 1
              and abs(float(bearing[0].split()[4]) - MRC_BEARING_DEG) < 1.0,
              f"cli mrc4: {bearing}, expected 640 EPCs and a bearing within 1 degree of 25")
        _, _, ms, _ = cli(argv, reps=3)
        times["decode --mrc (mrc4)"] = (ms, None)
        for a in ants:
            a.unlink()

        # sic2 under --epc-sic: 640 read, then 632 of tag 0x77 recovered.
        sic = CLI_DIR / "sic2.bin"
        write_trace(str(sic), np.concatenate([sic_scene(80).iq] * 8))
        argv = ["decode", sic, "--epc-sic", "--max-events", "1536"]
        _, text = cli_launches(argv, {"gate_front": 3, "gate_stack": 2}, "sic2")
        lines = text.splitlines()
        for want in ("| Correctly decoded EPC : 640", "| Tag ID : 41  Num of reads : 640",
                     "| EPC-window SIC: 632 extra EPCs recovered",
                     "| Tag 0x77 (SIC residual): 632 reads"):
            check(want in lines, f"cli sic2: no line {want!r}")
        _, _, ms, dec_ms = cli(argv, reps=3, timed_decode=True)
        times["decode --epc-sic (sic2)"] = (ms, dec_ms)
        sic.unlink()

        # wideband8 under --wideband 8: phase 11's per-channel counts.
        wide, occupied = CASES["wideband8"].capture()
        wb = CLI_DIR / "wideband8.bin"
        write_trace(str(wb), wide)
        argv = ["decode", wb, "--wideband", "8"]
        _, text = cli_launches(argv, {"gate_front": 8, "gate_stack": 8}, "wideband8")
        blocks = text.split("=== channel ")[1:]
        shown = {int(b.split()[0]): b for b in blocks}
        check(set(occupied) <= set(shown), f"cli wideband8: channels {sorted(shown)} printed")
        for k, block in shown.items():
            tag, want = occupied.get(k, (0, 0))
            check(f"| Correctly decoded EPC : {want}" in block.splitlines()
                  and (not want or f"| Tag ID : {tag:x}  Num of reads : {want}" in block),
                  f"cli wideband8 channel {k}: not {want} EPCs of tag {tag}")
        _, _, ms, _ = cli(argv, reps=3)
        times["decode --wideband 8 (wideband8)"] = (ms, None)

        # range over three hop captures, on the card and with --device cpu.
        hops = []
        for k, f in enumerate(HOPS_MHZ):
            hops.append(CLI_DIR / f"hop{k}.bin")
            rc, _, _, _ = cli(["simulate", hops[k], "--rounds", "20", "--tags", "27",
                               "--distance", "2.4", "--freq-mhz", f"{f}"])
            check(rc == 0, "cli simulate: non-zero exit")
        argv = ["range", *hops, "--freqs-mhz", *[f"{f}" for f in HOPS_MHZ]]
        _, text = cli_launches(argv, {"gate_front": 3, "gate_stack": 3}, "range")
        rc, text_cpu, _, _ = cli(["--device", "cpu", *argv])
        ranges = [float(t.splitlines()[0].split()[4]) for t in (text, text_cpu)]
        check(rc == 0 and abs(ranges[0] - ranges[1]) <= 0.001 and abs(ranges[0] - 2.4) < 0.05,
              f"cli range: {ranges[0]} m on the card, {ranges[1]} m on the CPU")

        rc, text, _, _ = cli(["txspec", "--tx-shape", "2.5"])
        check(rc == 0 and "| dense-interrogator mask: PASS" in text.splitlines(),
              "cli txspec --tx-shape 2.5: not a mask PASS")

        # The native (host C++) engine on the golden trace.
        t0 = time.perf_counter()
        eng = NativeEngine(ReaderConfig())
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.feed(tr_g.iq)
        st = eng.stats()
        feed_ms = (time.perf_counter() - t0) * 1e3
        log(f"[native] golden tuple {golden_tuple(st)}, {int(st.n_events)} events; build + load "
            f"{build_s:.1f} s, feed + stats {feed_ms:.1f} ms on the host CPU")
        check(golden_tuple(st) == GOLDEN and int(st.n_events) == 142,
              "native engine: golden tuple not reproduced")
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    for form, (ms, dec_ms) in times.items():
        inner = f", decode_capture inside {dec_ms:.3f} ms" if dec_ms is not None else ""
        log(f"[cli time] {form}: command {ms:.3f} ms{inner}")
    return main_launches, exact_launches


# Phase 17: the closed-loop live reader.  portal24 is tests/test_population.py's
# scene (24 tags, backlog Q from 0, SIC, A/B sessions, 40 round commands);
# the JAX package's counts for it, from its run on the CPU: queries, EPCs,
# target flips, second EPCs from EPC-window SIC, collided slots and the
# largest Q; every tag is read once a pass, 4 times.
PORTAL24 = {"n_queries": 277, "n_epc_correct": 96, "n_target_flips": 3,
            "n_epc_sic_second": 0, "n_collision_slots": 64, "max_q": 4}
# The shorter scenes held to the port's CPU run, each with its own check:
# the EPC-window SIC pair reads "6 3"; the link ladder walks FM0 -> M2 -> M4
# under a -20 dBc 40 kHz interferer, so the segment kernel runs at Miller-4's
# live shapes; TAM1 authenticates twice.
LIVE_SCENES = (
    ("sic_pair", lambda st: (st.n_epc_correct, st.n_epc_sic_second) == (6, 3)),
    ("ladder", lambda st: [m for _, m in st.link_trace] == [2, 4]),
    ("auth", lambda st: (st.n_auth_ok, st.n_auth_fail) == (2, 0)),
)
# Slots of the profiled window: a fresh portal24 reader's first 5 round
# commands (Q 0, 1, 2, 3, 4).
PROFILE_ROUNDS = 5


def live_profile(label, rounds):
    """torch.profiler over a fresh portal24 reader's first ``rounds`` round
    commands: device ops and host syncs a slot, the device's busy share of
    the window, and the share of the slots' time in the channel's host
    synthesis."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gen2_rfid_tpu_torch.tools.live_scenes import ExchangeTimer, build_scene

    reader, channel, _ = build_scene("portal24")
    timer = ExchangeTimer(channel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = reader.run_inventory(channel, rounds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    slots = st.n_queries
    events = prof.key_averages()
    dev_rows = [(e.self_device_time_total, e.count, e.key) for e in events
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in dev_rows)
    n_ops = sum(r[1] for r in dev_rows)
    syncs = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"))
    copies = sum(e.count for e in events if e.key.startswith("cudaMemcpy"))
    synth_s = sum(timer.seconds.values())
    out = {"slots": slots, "wall_ms_per_slot": wall_us / slots / 1e3,
           "device_ops_per_slot": n_ops / slots, "device_busy_ms_per_slot": busy_us / slots / 1e3,
           "busy_share": busy_us / wall_us, "syncs_per_slot": syncs / slots,
           "memcpy_per_slot": copies / slots,
           "synthesis_share": synth_s / sum(st.slot_latency_s)}
    log(f"[{label}] {slots} slots: wall {out['wall_ms_per_slot']:.3f} ms/slot under the "
        f"profiler, device busy {out['device_busy_ms_per_slot']:.4f} ms/slot "
        f"({100 * out['busy_share']:.1f}% busy), {out['device_ops_per_slot']:.1f} device ops/slot, "
        f"{out['syncs_per_slot']:.2f} host syncs/slot, {out['memcpy_per_slot']:.2f} "
        f"cudaMemcpy calls/slot; channel synthesis {100 * out['synthesis_share']:.1f}% "
        f"of slot time ({synth_s * 1e3 / slots:.3f} ms/slot)")
    for t, count, key in sorted(dev_rows, reverse=True)[:10]:
        log(f"[{label}] {t / slots:9.2f} us/slot {count:6d} calls  {key[:90]}")
    return out


def phase_live(dev, both, fmt, flush):
    """Phase 17: the closed-loop live reader on the card.  portal24 with the
    JAX package's counts, exactly one gate_front (y build) and one
    gate_stack launch a window decode, its block shapes and slot latency,
    and a profile of its first slots; three shorter scenes equal to the
    port's CPU runs; the CLI's ``live`` in a child process and in this
    one; both front
    kernels (gate_front's two builds) bit-equal to their plain versions at
    every live shape of portal24 and the ladder, and timed there beside
    their bounds, the y build at the fitting tile and at one tile an SM too.
    Returns {kernel: (launches, shape rows)}."""
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.kernels.gate_front import front_taps, gate_front, gate_front_plain
    from gen2_rfid_tpu_torch.kernels.gate_stack import (
        gate_stack_flags, gate_stack_plain, gate_stack_shape)
    from gen2_rfid_tpu_torch.tools.live_scenes import (
        DecodeLog, ExchangeTimer, build_scene, integer_fields)

    # portal24: counts, launches, shapes, latency.
    reader, channel, n_rounds = build_scene("portal24")
    check(reader.device.type == "cuda", f"portal24 reader on {reader.device}, not the card")
    decodes = DecodeLog(reader)
    timer = ExchangeTimer(channel)
    kernels.reset_launches()
    t0 = time.perf_counter()
    st = reader.run_inventory(channel, n_rounds)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    portal_launches = got = launch_counts()
    n_dec = len(decodes.calls)
    reads = {t: int(st.tag_reads[t]) for t in range(0x10, 0x10 + 24)}
    counts = {"n_queries": st.n_queries, "n_epc_correct": st.n_epc_correct,
              "n_target_flips": st.n_target_flips, "n_epc_sic_second": st.n_epc_sic_second,
              "n_collision_slots": st.n_collision_slots, "max_q": max(st.q_trace)}
    shapes = sorted(reader._block_shapes)
    lat = st.latency_summary()
    synth_ms = sum(timer.seconds.values()) * 1e3
    log(f"[portal24] {counts}; reads per tag {sorted(set(reads.values()))}; "
        f"{n_dec} window decodes, launches {got}; {wall_s:.2f} s wall")
    log(f"[portal24] block shapes (ADC samples, mode) {shapes}")
    log(f"[portal24] slot latency p50 {lat['p50_ms']:.3f} / p95 {lat['p95_ms']:.3f} / "
        f"mean {lat['mean_ms']:.3f} ms over {lat['n_slots']} slots; channel synthesis "
        f"{synth_ms:.1f} ms in all ({100 * synth_ms / (sum(st.slot_latency_s) * 1e3):.1f}% "
        f"of slot time)")
    check(counts == PORTAL24, f"portal24: {counts}, the JAX package's are {PORTAL24}")
    check(set(reads.values()) == {4}, f"portal24: reads per tag {reads}, expected 4 each")
    check(got == counts_of(n_dec, n_dec),
          f"portal24: launches {got} for {n_dec} window decodes, expected one "
          f"gate_front (y build) and one gate_stack a decode")
    check(len(shapes) <= 5, f"portal24: {len(shapes)} block shapes, expected at most 5")
    profile = live_profile("profile portal24", PROFILE_ROUNDS)

    # The shorter scenes: the card's run against the port's CPU run.
    blocks = dict(decodes.blocks)
    for name, ok in LIVE_SCENES:
        reader, channel, n_rounds = build_scene(name)
        log_s = DecodeLog(reader)
        kernels.reset_launches()
        st = reader.run_inventory(channel, n_rounds)
        torch.cuda.synchronize()
        got = launch_counts()
        n_dec = len(log_s.calls)
        reader_c, channel_c, _ = build_scene(name, device="cpu")
        st_cpu = reader_c.run_inventory(channel_c, n_rounds)
        a, b = integer_fields(st), integer_fields(st_cpu)
        log(f"[live {name}] {st.n_queries} queries, {st.n_epc_correct} EPCs; {n_dec} window "
            f"decodes, launches {got}; latency p50 {st.latency_summary()['p50_ms']:.3f} ms")
        check(a == b, f"live {name}: card != CPU on {[k for k in a if a[k] != b[k]]}")
        check(ok(st), f"live {name}: not its expected counts")
        check(got == counts_of(n_dec, n_dec),
              f"live {name}: launches {got} for {n_dec} window decodes")
        log(f"[live {name}] card == CPU on every integer field of LiveStats")
        if name == "ladder":
            for key, block in log_s.blocks.items():
                blocks.setdefault(key, block)

    # The CLI's live subcommand as a user starts it.
    argv = ["live", "--rounds", "3", "--tags", "27", "9", "--sic"]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "gen2_rfid_tpu_torch.apps.reader", *argv],
                         cwd=str(REPO), capture_output=True, text=True, timeout=600)
    log(f"[cli python -m live] exit {out.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in (out.stdout + out.stderr).strip("\n").splitlines():
        log(f"[cli python -m live] {line}")
    lines = out.stdout.splitlines()
    check(out.returncode == 0, f"python -m ... live: exit {out.returncode}")
    # The same command in this process, so that the kernels are held at its
    # windows' shapes too (main keeps their inputs through the phase).
    rc, text, _, _ = cli(argv)
    check(rc == 0, f"live in process: exit {rc}")
    for want in ("| Correctly decoded EPC : 3", "| Collided slots recovered via SIC: 3"):
        check(want in lines, f"python -m ... live: no line {want!r}")
        check(want in text.splitlines(), f"live in process: no line {want!r}")

    # The kernels at every live shape: bit-equal, shaped and timed.
    rows = {"gate_front": [], "gate_front_y": [], "gate_stack": []}
    for (cfg, n), (mode, block2) in sorted(blocks.items(),
                                           key=lambda kv: (kv[0][0].miller_m, kv[0][1])):
        x2 = torch.from_numpy(block2).to(dev)
        geo_f = (cfg.decim, front_taps(cfg), cfg.win_length, cfg.dc_length)
        geo_s = (cfg.win_length, cfg.n_samples_pw // 2, cfg.n_samples_t1, cfg.thresh_fraction)
        got_f = gate_front(x2, *geo_f)
        want_f = gate_front_plain(x2, *geo_f)
        y2 = got_f[0]
        got_s, want_s = gate_stack_flags(y2, *geo_s), gate_stack_plain(y2, *geo_s)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got_f, want_f)),
              f"live M={cfg.miller_m} N={n}: gate_front is not bit-equal to its plain version")
        check(torch.equal(got_s, want_s),
              f"live M={cfg.miller_m} N={n}: gate_stack flags differ from the plain version")
        ny = y2.shape[1]
        shp = gate_stack_shape(ny, *geo_s[:3])
        tf = both(lambda: gate_front(x2, *geo_f), 50)
        ts = both(lambda: gate_stack_flags(y2, *geo_s), 50)
        fb, fby = front_bound(n, ny, *geo_f[1:])
        sb, sby = stack_bound(ny, cfg.win_length)
        label = f"M={cfg.miller_m} {mode} N={n} Ny={ny}"
        log(f"[live kernels {label}] both bit-equal to plain; gate_stack shape {shp}")
        log(f"[time] live {label}: gate_front {fmt(tf)}, bound {fb:.6f} ms ({fby}); "
            f"gate_stack {fmt(ts)}, bound {sb:.6f} ms ({sby})")
        base = {"miller_m": cfg.miller_m, "mode": mode, "n": n, "ny": ny}
        rows["gate_front"].append({**base, "ms": tf["write"], "ms_read": tf["read"],
                                   "bound_ms": fb, "bound_by": fby})
        rows["gate_front_y"].append({**base, **y_report(f"live {label}", x2, geo_f, both, fmt,
                                                        full_y=y2, reps=50),
                                     "tiles": tile_vs_spread(f"live {label}", x2,
                                                             *geo_f[:2], flush)})
        rows["gate_stack"].append({**base, "ms": ts["write"], "ms_read": ts["read"],
                                   "bound_ms": sb, "bound_by": sby, "grid": shp["grid"],
                                   "run": shp["run"]})
    log(f"[live] profile {json.dumps(profile)}")
    keys = {"gate_front": "front_full", "gate_front_y": "front_y", "gate_stack": "gate_stack"}
    return {k: (portal_launches[keys[k]], v) for k, v in rows.items()}


# Phase 18's per-run table caps: the bench capture's 1,280 command events
# at n_time 1, 2 and 8; longcap's 5,120 at 8; miller4 (960) and blf640
# (520) at 8.
SHARDED_BENCH = ((1, 1536), (2, 1024), (8, 256))
SHARDED_CASES = (
    ("miller4", dict(miller_m=4, decim=1, max_events=1280), 24, 480),
    ("blf640", dict(blf_hz=640e3, adc_rate=8e6, decim=2, max_events=768), 13, 260),
)


def sharded_run(label, x2, cfg, n_time, eps, single, want_epc, dev, want=None):
    """One time-sharded decode of the planar (2, N) ``x2`` over ``n_time``
    positions of ``dev``, the counts set to 0 just before it and read just
    after: exactly n_time launches of each front kernel, every EPC, each
    shard's gate count within its table, and stats in every field and the
    owned trigger indices equal to ``single``, the single decode of the same
    capture; with ``want``, those launches instead (compat mode).  Returns
    (launches, decoder)."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.shard.decode_sharded import make_sharded_decoder
    from gen2_rfid_tpu_torch.shard.mesh import make_mesh

    decoder = make_sharded_decoder(cfg, make_mesh(n_time, devices=[dev] * n_time), eps)
    kernels.reset_launches()
    st, dec, gated = decoder(x2[None], with_gated=True)
    torch.cuda.synchronize()
    got = launch_counts()
    gated = gated[:, 0].tolist()
    log(f"[{label} n_time={n_time}] launches {got}; gate triggers a shard, halo included "
        f"{gated} against a table of {eps}; {int(st.n_epc_correct[0])} EPCs")
    want = counts_of(n_time, n_time) if want is None else want
    check(got == want, f"{label} n_time={n_time}: launches {got}, expected {want}")
    check(max(gated) <= eps, f"{label} n_time={n_time}: a shard gated {max(gated)} > {eps}")
    check(int(st.n_epc_correct[0]) == want_epc,
          f"{label} n_time={n_time}: {int(st.n_epc_correct[0])} EPCs, expected {want_epc}")
    st1, dec1 = single
    for f in st1._fields:
        check(torch.equal(getattr(st, f)[0], getattr(st1, f)),
              f"{label} n_time={n_time}: InventoryStats.{f} != the single decode's")
    idx = np.sort(dec.index[0][dec.valid[0]].cpu().numpy())
    check(np.array_equal(idx, np.sort(dec1.index[dec1.valid].cpu().numpy())),
          f"{label} n_time={n_time}: owned trigger indices != the single decode's")
    log(f"[{label} n_time={n_time}] stats in every field and the {idx.size} owned trigger "
        f"indices equal to the single decode's")
    return got, decoder


def block_kernel_checks(label, x2, cfg, n_time):
    """Both front kernels against their plain versions on every block a
    sharded decode of ``x2`` ((2, N), or (C, 2, N) with one block a channel)
    over n_time shards launches them on, cut as the decoder cuts them
    (``extended_block``): gate_front's full build bit for bit at the padded
    block ``front_valid`` hands it, its y build at the same block
    (``_fir_valid``'s) bit-equal to its plain version and to the full
    build's y, gate_stack's flags bit for bit at the case's geometry on that
    block's y.  Returns the (N, Ny) checked."""
    import torch

    from gen2_rfid_tpu_torch.kernels.gate_front import (
        front_taps, gate_front, gate_front_plain, gate_front_y, gate_front_y_plain)
    from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_for_cfg, gate_stack_plain
    from gen2_rfid_tpu_torch.shard.decode_sharded import _halo_x, extended_block, front_input

    rows = x2[None] if x2.dim() == 2 else x2
    n_loc = rows.shape[2] // n_time
    halo = _halo_x(cfg, n_loc)
    geo_f = (cfg.decim, front_taps(cfg), cfg.win_length, cfg.dc_length)
    geo_s = (cfg.win_length, cfg.n_samples_pw // 2, cfg.n_samples_t1, cfg.thresh_fraction)
    for c, row in enumerate(rows):
        for t in range(n_time):
            xp, k0, n_valid = front_input(extended_block(row, t, n_loc, halo), cfg)
            got_f, want_f = gate_front(xp, *geo_f), gate_front_plain(xp, *geo_f)
            got_y = gate_front_y(xp, *geo_f[:2])
            y2 = got_f[0][:, k0:k0 + n_valid].contiguous()
            got_s = gate_stack_for_cfg(y2, cfg) if cfg.mode != "compat" else None
            want_s = gate_stack_plain(y2, *geo_s) if got_s is not None else None
            torch.cuda.synchronize()
            at = f"{label} n_time={n_time} channel {c} shard {t}: N={xp.shape[1]}"
            check(all(torch.equal(g, w) for g, w in zip(got_f, want_f)),
                  f"gate_front is not bit-equal to its plain version at {at}")
            check(torch.equal(got_y, got_f[0]) and torch.equal(got_y, gate_front_y_plain(
                xp, *geo_f[:2])), f"gate_front_y is not bit-equal to its plain version and "
                                  f"the full build's y at {at}")
            check(got_s is None or torch.equal(got_s, want_s),
                  f"gate_stack flags differ from the plain version at {at}, Ny={n_valid}")
    log(f"[sharded kernels] {label} n_time={n_time}: gate_front (both builds) and gate_stack "
        f"bit-equal to their plain versions on all {rows.shape[0] * n_time} blocks, N={xp.shape[1]} "
        f"(halos {halo[0]} + {halo[1]}, padded as front_valid pads), Ny={n_valid}")
    return xp.shape[1], n_valid


def phase_sharded(dev, iq_b, both, fmt):
    """Phase 18: the time- and channel-sharded decode on the card.  The bench
    capture at n_time 1, 2 and 8, longcap, miller4 and blf640 at 8, each
    equal to its single decode through n_time launches of each front
    kernel, timed beside it; both kernels bit-equal to their plain versions
    at a bench shard's extended shape and timed there; wideband8 through
    ``decode_wideband_sharded`` on a 2 x 2 mesh; the bench capture as a file
    through two CUDA worker processes of four shards each, and its eight
    blocks in this process; the dry run on 8 positions.  Returns the bench n_time 8 launches and the shard-shape
    kernel rows."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.dsp.channelizer import channelize_planar, decode_wideband_sharded
    from gen2_rfid_tpu_torch.io.tracefile import write_trace
    from gen2_rfid_tpu_torch.kernels.gate_front import front_taps, gate_front
    from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_flags
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.runtime.stats import unique_tags
    from gen2_rfid_tpu_torch.shard.decode_sharded import _halo_x, extended_block, front_input
    from gen2_rfid_tpu_torch.shard.dryrun import dryrun_multichip
    from gen2_rfid_tpu_torch.shard.distributed import decode_file_distributed
    from gen2_rfid_tpu_torch.shard.launch import run_local
    from gen2_rfid_tpu_torch.shard.mesh import make_mesh
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
    from gen2_rfid_tpu_torch.tools.bench_configs import CASES
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    def padded(iq, mult):
        return to_planar(np.pad(iq, (0, (-iq.size) % mult))).to(dev)

    # The bench capture at n_time 1, 2 and 8.
    cfg_b = ReaderConfig(max_events=1536)
    x2_b = padded(iq_b, 8 * cfg_b.decim)
    single_b = decode_capture_planar(x2_b, cfg_b)
    single_ms = cuda_ms(lambda: decode_capture_planar(x2_b, cfg_b), 7)
    times = {}
    for n_time, eps in SHARDED_BENCH:
        got, decoder = sharded_run("bench", x2_b, cfg_b, n_time, eps, single_b, 640, dev)
        block_kernel_checks("bench", x2_b, cfg_b, n_time)
        if n_time == 8:
            bench_launches, decoder_8 = got, decoder
        times[n_time] = cuda_ms(lambda: decoder(x2_b[None]), 7)
    log(f"[time] bench N={x2_b.shape[1]}: single decode {single_ms:.3f} ms; sharded " + ", ".join(
        f"n_time={t} {ms:.3f} ms ({ms / single_ms:.2f}x)" for t, ms in times.items()))
    device_profile(lambda: decoder_8(x2_b[None]), top=8, label="profile sharded bench n_time=8")

    # Both front kernels timed at one bench shard's block (shard 3 of 8), as
    # front_valid and _fir_valid hand it to gate_front's builds.
    n_loc = x2_b.shape[1] // 8
    hl_x, hr_x = _halo_x(cfg_b, n_loc)
    x_ext, k0, n_valid = front_input(extended_block(x2_b, 3, n_loc, (hl_x, hr_x)), cfg_b)
    geo_f = (cfg_b.decim, front_taps(cfg_b), cfg_b.win_length, cfg_b.dc_length)
    geo_s = (cfg_b.win_length, cfg_b.n_samples_pw // 2, cfg_b.n_samples_t1,
             cfg_b.thresh_fraction)
    got_f = gate_front(x_ext, *geo_f)
    y2 = got_f[0][:, k0:k0 + n_valid].contiguous()
    n_x, ny = x_ext.shape[1], y2.shape[1]
    tf, ts = both(lambda: gate_front(x_ext, *geo_f), 20), both(lambda: gate_stack_flags(y2, *geo_s), 20)
    fb, fby = front_bound(n_x, got_f[0].shape[1], *geo_f[1:])
    sb, sby = stack_bound(ny, cfg_b.win_length)
    log(f"[time] bench shard 3 of 8, N={n_x} (halos {hl_x} + {hr_x}, padded as front_valid "
        f"pads), Ny={ny}: gate_front {fmt(tf)}, bound {fb:.4f} ms ({fby}); "
        f"gate_stack {fmt(ts)}, bound {sb:.4f} ms ({sby})")
    shard_rows = {
        "gate_front": {"n": n_x, "ms": tf["write"], "ms_read": tf["read"], "bound_ms": fb,
                       "bound_by": fby},
        "gate_front_y": y_report("bench shard 3 of 8", x_ext, geo_f, both, fmt,
                                 full_y=got_f[0]),
        "gate_stack": {"ny": ny, "ms": ts["write"], "ms_read": ts["read"], "bound_ms": sb,
                       "bound_by": sby}}
    del got_f, x_ext, y2

    # longcap: the bench trace tiled 32 times.
    cfg_l = ReaderConfig(max_events=6144, max_num_queries=1_000_000)
    x2_l = padded(np.concatenate([iq_b] * 4), 8 * cfg_l.decim)
    single_l = decode_capture_planar(x2_l, cfg_l)
    _, dec_l = sharded_run("longcap", x2_l, cfg_l, 8, 1536, single_l, 2560, dev)
    block_kernel_checks("longcap", x2_l, cfg_l, 8)
    t1 = cuda_ms(lambda: decode_capture_planar(x2_l, cfg_l), 3)
    t8 = cuda_ms(lambda: dec_l(x2_l[None]), 3)
    log(f"[time] longcap N={x2_l.shape[1]}: single decode {t1:.3f} ms, sharded n_time=8 "
        f"{t8:.3f} ms ({t8 / t1:.2f}x)")
    del x2_l, single_l, dec_l

    # miller4 and blf640 at full size: the segment kernel on the sharded path.
    for name, kw, reps, want_epc in SHARDED_CASES:
        c = ReaderConfig(**kw)
        tr = synthesize_inventory(c, [Tag.with_id(27, seed=7)], n_rounds=20, seed=2)
        x2 = padded(np.concatenate([tr.iq] * reps), 8 * c.decim)
        single = decode_capture_planar(x2, c)
        _, dec_c = sharded_run(name, x2, c, 8, 256, single, want_epc, dev)
        block_kernel_checks(name, x2, c, 8)
        t1 = cuda_ms(lambda: decode_capture_planar(x2, c), 3)
        t8 = cuda_ms(lambda: dec_c(x2[None]), 3)
        log(f"[time] {name} N={x2.shape[1]}: single decode {t1:.3f} ms, sharded n_time=8 "
            f"{t8:.3f} ms ({t8 / t1:.2f}x)")

    # wideband8 on a 2 time x 2 chan mesh of the card.
    wide, occupied = CASES["wideband8"].capture()
    cfg_w = ReaderConfig(max_events=256)
    mesh_w = make_mesh(2, 2, devices=[dev] * 4)
    kernels.reset_launches()
    st_w, _ = decode_wideband_sharded(wide, 8, cfg_w, mesh_w, events_per_shard=128)
    torch.cuda.synchronize()
    got = launch_counts()
    log(f"[wideband sharded] 2 time x 2 chan: launches {got}; EPCs a channel "
        f"{st_w.n_epc_correct.tolist()}")
    check(got == counts_of(16, 16), "wideband sharded: one gate_front (y build) and one "
                                     "gate_stack a (time shard, channel)")
    for k in range(8):
        tag, want = occupied.get(k, (0, 0))
        n_ok = int(st_w.n_epc_correct[k])
        check(n_ok == want and (not want or int(st_w.tag_reads[k, tag]) == want),
              f"wideband sharded channel {k}: {n_ok} EPCs, expected {want}")
    ch = channelize_planar(to_planar(wide).to(dev), 8, 12)
    m_use = ch.shape[2] - ch.shape[2] % (2 * cfg_w.decim)
    block_kernel_checks("wideband8", ch[:, :, :m_use], cfg_w, 2)
    del ch
    wide_ms = cuda_ms(lambda: decode_wideband_sharded(wide, 8, cfg_w, mesh_w, 128), 3)
    log(f"[time] wideband8 sharded 2 x 2 (host capture in, channelizer included) "
        f"{wide_ms:.3f} ms for {wide.size} samples")

    # The bench capture as a file, through two CUDA worker processes.
    path = REPO / "build" / "chip_smoke_shard" / "bench.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_trace(str(path), iq_b)
    st_1, _ = decode_capture_planar(to_planar(iq_b).to(dev), cfg_b)
    want_rec = {"num_processes": 2, "n_devices": 8, "n_queries": int(st_1.n_queries),
                "n_epc_correct": int(st_1.n_epc_correct),
                "round": int(st_1.cur_inventory_round), "unique_tags": unique_tags(st_1),
                "tag_reads": {str(t): int(st_1.tag_reads[t])
                              for t in torch.nonzero(st_1.tag_reads).flatten().tolist()}}
    t0 = time.perf_counter()
    start = subprocess.run(
        [sys.executable, "-c", "import torch, gen2_rfid_tpu_torch.shard.distributed; "
         "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"],
        cwd=str(REPO), capture_output=True, text=True, timeout=300)
    start_s = time.perf_counter() - t0
    check(start.returncode == 0, f"a bare worker start failed: {start.stderr[-500:]}")
    t0 = time.perf_counter()
    rec = run_local(str(path), 2, 4, "cuda", events_per_shard=256, max_events=1536,
                    timeout=600.0)
    dist_s = time.perf_counter() - t0
    log(f"[distributed] 2 CUDA processes x 4 shards: {json.dumps(rec, sort_keys=True)}")
    log(f"[time] distributed bench file decode {dist_s:.2f} s wall; one process's start "
        f"alone (interpreter, import torch and the package, CUDA context) {start_s:.2f} s")
    check({k: rec[k] for k in want_rec} == want_rec,
          f"distributed record {rec} != the single decode's {want_rec}")
    # The workers' eight blocks, cut as they cut them, in one process here,
    # so that the kernels are held at their shapes too (main keeps their
    # inputs through the phase).
    st_f, _ = decode_file_distributed(str(path), cfg_b, events_per_shard=256,
                                      shards_per_process=2 * 4)
    check(int(st_f.n_epc_correct) == rec["n_epc_correct"]
          and int(st_f.n_queries) == rec["n_queries"],
          f"the file decode of 8 shards in one process: {int(st_f.n_epc_correct)} EPCs, "
          f"{int(st_f.n_queries)} queries; the workers' record {rec}")
    path.unlink()

    # The dry run on 8 positions of the card.
    try:
        dryrun_multichip(8)
    except AssertionError as err:
        raise SmokeFailure(f"dryrun_multichip(8): {err}")
    return bench_launches, shard_rows


# Phase 19: the envelope sweeps (gen2_rfid_tpu_torch/tools/).  The softfix
# campaign whole, with the JAX tool's counts from its run on the CPU
# (tools/softfix_false_accept.py at seed 0: 49 batches of 4,096 frames,
# false accepts a mode).
SOFTFIX_FRAMES, SOFTFIX_BATCH, SOFTFIX_FRAMES_DRAWN = 200_000, 4096, 200_704
SOFTFIX_JAX = {"native": 8, "compat": 104}


def sweep_tables(device: str):
    """Each of the sweep rows' (``tools/sweep.py``) printed lines, wall
    seconds, decodes and kernel launches on ``device`` (the CPU's run is a
    child process's, as JSON)."""
    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.runtime import inventory
    from gen2_rfid_tpu_torch.tools.sweep import rows, run_twin

    out = []
    for _, twin, argv, _ in rows():
        d0, k0 = inventory.decodes["capture"], launch_counts()
        lines, seconds = run_twin(twin, argv, device)
        k1 = launch_counts()
        out.append({"lines": lines, "s": seconds,
                    "decodes": inventory.decodes["capture"] - d0,
                    "launches": {k: k1[k] - k0[k] for k in k0}})
    return out


def kept_kernel_checks():
    """gate_front's two builds, gate_stack, compat_gate and gate_pulses
    against their plain versions, bit for bit, on every input a run launched
    them on (one a shape and geometry, kept by ``kernels.keep_inputs``;
    compat_gate's amp and avg stacked).  Returns the (kernel, N) checked,
    gate_front's y build as ``gate_front_y``."""
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.dsp.gate import gate_pulses_plain
    from gen2_rfid_tpu_torch.kernels.gate_pulses import gate_pulses
    from gen2_rfid_tpu_torch.kernels.gate_front import (
        gate_front, gate_front_plain, gate_front_y, gate_front_y_plain)
    from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_flags, gate_stack_plain
    from gen2_rfid_tpu_torch.kernels.compat_gate import compat_gate, compat_gate_plain

    checked = []
    for (name, shape, *geo), x in kernels.kept.items():
        if name == "compat_gate":
            got, want = compat_gate(x[0], x[1], *geo), compat_gate_plain(x[0], x[1], *geo)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
        elif name == "gate_pulses":
            got, want = gate_pulses(x, *geo), gate_pulses_plain(x, *geo)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
        elif name == "gate_front" and geo[0] == "y":
            name = "gate_front_y"
            same = torch.equal(gate_front_y(x, *geo[1:3], block_y=geo[3]),
                               gate_front_y_plain(x, *geo[1:3]))
        elif name == "gate_front":
            got = gate_front(x, *geo[1:5], block_y=geo[5])
            same = all(torch.equal(g, w) for g, w in zip(got, gate_front_plain(x, *geo[1:5])))
        else:
            same = torch.equal(gate_stack_flags(x, *geo), gate_stack_plain(x, *geo[:4]))
        check(same, f"{name} is not bit-equal to its plain version at the kept "
                    f"shape {shape}, geometry {tuple(geo)}")
        checked.append((name, shape[-1]))
    return checked


def hold_kept(label):
    """Stop keeping, hold every input kept since ``keep_inputs(True)``
    against its kernel's plain version (``kept_kernel_checks``), log the
    shapes, and start keeping anew for what follows.  Returns the (kernel,
    N) checked."""
    from gen2_rfid_tpu_torch import kernels

    kernels.keep_inputs(False)
    checked = kept_kernel_checks()
    by_kernel = {}
    for k, n in checked:
        by_kernel.setdefault(k, set()).add(n)
    log(f"[kept kernels {label}] bit-equal to their plain versions on the "
        f"{len(checked)} input shapes and geometries launched: " + "; ".join(
            f"{k} {'Ny' if k in ('gate_stack', 'compat_gate', 'gate_pulses') else 'N'} "
            f"{sorted(ns)}"
            for k, ns in sorted(by_kernel.items())))
    kernels.keep_inputs(True)
    return checked


def spread_tile(ny, fitting):
    """The tile of gate_front's y build that gives each SM one for Ny
    outputs (a multiple of 8), at most the ``fitting`` one."""
    import torch

    from gen2_rfid_tpu_torch.kernels.gate_front import Y_GROUP

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return min(fitting, max(Y_GROUP, -(-ny // (sms * Y_GROUP)) * Y_GROUP))


def tile_vs_spread(label, x2, decim, taps, flush, reps=50):
    """gate_front_y at the fitting tile (``_fitting_y_tile``: the largest
    whose slabs fit shared memory) and at one tile an SM (``spread_tile``),
    each bit-equal to its plain version and timed under the read flush.
    Returns {"ny", "fitting", "spread", "fitting_ms", "spread_ms"}."""
    import torch

    from gen2_rfid_tpu_torch.kernels.gate_front import (
        _fitting_y_tile, gate_front_y, gate_front_y_plain)
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    ny = x2.shape[1] // decim
    fitting = _fitting_y_tile(decim, taps)
    row = {"ny": ny, "fitting": fitting, "spread": spread_tile(ny, fitting)}
    want = gate_front_y_plain(x2, decim, taps)
    for key in ("fitting", "spread"):
        tile = row[key]
        check(torch.equal(gate_front_y(x2, decim, taps, block_y=tile), want),
              f"{label}: gate_front_y at block_y={tile} is not bit-equal to its plain version")
        row[f"{key}_ms"] = cuda_ms(lambda tile=tile: gate_front_y(x2, decim, taps, block_y=tile),
                                   reps, flush, flush_by="read")
    log(f"[y tile {label}] Ny={ny} (decim {decim}, taps {taps}): fitting tile {row['fitting']} "
        f"{row['fitting_ms']:.4f} ms, one tile an SM {row['spread']} {row['spread_ms']:.4f} ms "
        f"(read flush, median of {reps}); both bit-equal to plain")
    return row


def phase_sweeps(dev):
    """Phase 19: the envelope sweeps on the card.  The softfix campaign
    whole (200,000 frames a mode at seed 0, batches of 4,096): the JAX
    tool's counts.  One row of each other twin (``tools/sweep.py``'s
    ``ROWS``), its printed lines and its count of decodes equal to the port's
    CPU run of the same rows (a child process, run meanwhile), through
    exactly one gate_front (y build) and one gate_stack launch a decode and
    none elsewhere; then both kernels bit-equal to their plain versions on
    every input shape the rows gave them.  Returns the launches: gate_front's,
    its y build's, and gate_stack's by kernel body."""
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.tools.softfix_false_accept import false_accepts
    from gen2_rfid_tpu_torch.tools.sweep import rows, table_diff

    child = subprocess.Popen(
        [sys.executable, "-c",
         "import json, chip_smoke; print(json.dumps(chip_smoke.sweep_tables('cpu')))"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for mode in ("native", "compat"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            accepts, frames = false_accepts(mode, SOFTFIX_FRAMES, SOFTFIX_BATCH, 0, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"[sweeps] softfix {mode}: {accepts} false accepts in {frames} frames "
                f"(rate {accepts / frames:.4g}; the JAX tool on the CPU: "
                f"{SOFTFIX_JAX[mode]}), {wall:.3f} s wall")
            check(frames == SOFTFIX_FRAMES_DRAWN and accepts == SOFTFIX_JAX[mode],
                  f"softfix {mode}: {accepts} in {frames}, the JAX tool's "
                  f"{SOFTFIX_JAX[mode]} in {SOFTFIX_FRAMES_DRAWN}")
            check(not any(kernels.launches.values()),
                  f"softfix launched kernels: {kernels.launches}")

        kernels.reset_launches()
        kernels.keep_inputs(True)
        try:
            card = sweep_tables("cuda")
        finally:
            kernels.keep_inputs(False)
        launches, bodies = dict(kernels.launches), dict(kernels.stack_bodies)
        fronts = dict(kernels.front_bodies)

        out, err = child.communicate(timeout=900)
        check(child.returncode == 0, f"the sweeps' CPU run failed: {err[-2000:]}")
        cpu = json.loads(out.strip().splitlines()[-1])
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    for (label, _, argv, digits), c, h in zip(rows(), card, cpu):
        label = f"{label}: {' '.join(argv)}"
        for line in c["lines"]:
            log(f"[sweeps {label}] {line}")
        log(f"[time] sweep {label}: {c['s']:.3f} s wall on the card, {h['s']:.3f} s on "
            f"the CPU; {c['decodes']} decodes, launches {c['launches']}")
        bad = table_diff(c["lines"], h["lines"], last_digits=digits)
        check(not bad, f"{label}: the card's table differs from the CPU's: {bad}")
        n = c["decodes"]
        check(n == h["decodes"], f"{label}: {n} decodes on the card, {h['decodes']} on the CPU")
        check(c["launches"] == counts_of(n, n),
              f"{label}: launches {c['launches']} for {n} native single-channel decodes, "
              "expected one gate_front (y build), one gate_stack and one gate_pulses launch "
              "a decode")
    n_dec = sum(c["decodes"] for c in card)
    check(n_dec > 0 and launches["gate_front"] == n_dec and fronts == {"full": 0, "y": n_dec}
          and sum(bodies.values()) == launches["gate_stack"] == launches["gate_pulses"]
          and bodies["stream"] > 0 and bodies["segment"] > 0,
          f"sweep launches {launches}, gate_front by build {fronts}, gate_stack by body "
          f"{bodies}, for {n_dec} decodes")
    log(f"[sweeps] every table and count of decodes equals the port's CPU run of the same "
        f"rows; {n_dec} decodes, each one gate_front (y build) and one gate_stack launch "
        f"({bodies['stream']} stream, {bodies['segment']} segment kernel)")

    checked = kept_kernel_checks()
    torch.cuda.synchronize()
    check({k for k, _ in checked} == {"gate_front_y", "gate_stack", "gate_pulses"},
          f"the sweeps kept inputs of {sorted({k for k, _ in checked})}")
    for name in ("gate_front_y", "gate_stack", "gate_pulses"):
        ns = sorted({n for k, n in checked if k == name})
        log(f"[sweeps kernels] {name} bit-equal to its plain version on the "
            f"{sum(k == name for k, _ in checked)} input shapes and geometries the rows "
            f"launched it on: {'N' if name == 'gate_front_y' else 'Ny'} {ns}")

    miller = card[[r[0] for r in rows()].index("miller")]["lines"]
    cells = [json.loads(line) for line in miller[:-1]]
    failed = [(c["m"], c["blf_off"], c["interferer"], c["cfo_tracked"])
              for c in cells if not c["exact"]]
    check(len(cells) == 24 and all(m == 2 and interf for m, _, interf, _ in failed)
          and len(failed) == 4 and miller[-1] == '{"summary": "20/24 exact"}',
          f"Miller matrix: {miller[-1]}, failing {failed}; the JAX tool's run fails "
          "exactly the four M=2 + interferer cells")
    return {"gate_front": launches["gate_front"], "front_y": fronts["y"],
            "gate_pulses": launches["gate_pulses"],
            "stream": bodies["stream"], "segment": bodies["segment"]}


# Phase 20: the bench twins (gen2_rfid_tpu_torch/tools/bench*.py) at full
# size.  Each line's EPCs a decode (the JAX scripts' captures, counted on the
# CPU), and the gate_stack body each single-channel case runs.
BENCH_DECODES = 5
BENCH_N = 9_704_304
BENCH_EPCS = {"iq_decode_throughput": 640, "multitag_q4": 152, "miller4": 480,
              "miller2": 400, "miller8_trext": 120, "blf640": 260, "blf160": 400,
              "wideband8": 108, "longcap": 2560}
BENCH_SEGMENT = ("miller4", "miller2", "miller8_trext", "blf640", "blf160")
# bench_scaling under --positions 8: 40 rounds tiled 8 times.
SCALING_POSITIONS, SCALING_EPCS = 8, 320


def bench_run(twin, argv):
    """A bench twin's ``main(argv)`` on the card, the counts set to 0 just
    before it and read just after, keeping the kernels' inputs: (its JSON
    lines, the launches of all its decodes, the first decode included)."""
    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.tools.sweep import run_twin

    kernels.reset_launches()
    kernels.keep_inputs(True)
    try:
        lines, seconds = run_twin(twin, list(argv) + ["--decodes", str(BENCH_DECODES)], "cuda")
    finally:
        kernels.keep_inputs(False)
    got = {"gate_front": kernels.launches["gate_front"], "front_y": kernels.front_bodies["y"],
           "front_full": kernels.front_bodies["full"], "stream": kernels.stack_bodies["stream"],
           "segment": kernels.stack_bodies["segment"], "gate_scan": kernels.launches["gate_scan"],
           "gate_pulses": kernels.launches["gate_pulses"]}
    log(f"[bench] {twin} {' '.join(argv)}: {seconds:.3f} s wall, launches {got}")
    for line in lines:
        log(f"[bench line] {line}")
    return [json.loads(line) for line in lines], got


def phase_bench(dev, both, fmt):
    """Phase 20: the three bench twins' ``main``s at full size on the card,
    ``BENCH_DECODES`` timed decodes each: the flagship, each of the eight
    cases (one ``main`` a case), and the scaling harness at 8 positions.
    Each line names the card and its power limit and reads its EPCs on every
    decode; every decode launches exactly one gate_front (its y build) and,
    native single-channel, one gate_stack (wideband8: one of each a channel;
    the sharded decode one of each a position); both kernels are then
    bit-equal to their plain versions on every input each run launched them
    on, multitag_q4's and blf160's among them, and gate_front's y build is
    timed on blf640's and blf160's.  Returns the launches (gate_front's, its
    y build's, gate_stack's by kernel body) and the y build's rows."""
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.kernels.gate_front import front_taps
    from gen2_rfid_tpu_torch.tools.bench_configs import CASES

    name = torch.cuda.get_device_name(0)
    total = {"gate_front": 0, "front_y": 0, "stream": 0, "segment": 0, "gate_pulses": 0}
    y_rows = {}
    runs = [("bench", [], "iq_decode_throughput")]
    runs += [("bench_configs", ["--configs", case], case) for case in CASES]
    for twin, argv, label in runs:
        lines, got = bench_run(twin, argv)
        check(len(lines) == 1, f"{label}: {len(lines)} lines")
        line = lines[0]
        check(line["device"] == name and line["power_limit_w"] is not None,
              f"{label}: device {line['device']}, power limit {line['power_limit_w']}")
        check(line["epcs"] == BENCH_EPCS[label] and line["decodes"] == BENCH_DECODES,
              f"{label}: {line['epcs']} EPCs a decode, expected {BENCH_EPCS[label]}")
        n_chan = 8 if label == "wideband8" else 1
        body = "segment" if label in BENCH_SEGMENT else "stream"
        want = {"gate_front": n_chan, "gate_stack_stream": n_chan * (body == "stream"),
                "gate_stack_segment": n_chan * (body == "segment"), "gate_scan": 0}
        check(line["launches"] == want, f"{label}: launches a decode {line['launches']}, "
                                        f"expected {want}")
        runs_n = BENCH_DECODES + 1
        check(got == {"gate_front": runs_n * n_chan, "front_y": runs_n * n_chan, "front_full": 0,
                      body: runs_n * n_chan, ("segment" if body == "stream" else "stream"): 0,
                      "gate_scan": 0, "gate_pulses": runs_n * n_chan},
              f"{label}: {got} for {runs_n} decodes of {n_chan} channel(s)")
        if label == "iq_decode_throughput":
            check(line["samples_per_iter"] == BENCH_N, f"flagship N {line['samples_per_iter']}")
        if label == "wideband8":
            check(line["epcs_by_channel"] == [0, 54, 0, 0, 0, 0, 54, 0],
                  f"wideband8 EPCs by channel {line['epcs_by_channel']}")
        else:
            log(f"[bench roles] {label}: {line['roles']}")
        checked = kept_kernel_checks()
        check({k for k, _ in checked} == {"gate_front_y", "gate_stack", "gate_pulses"},
              f"{label}: kept inputs {checked}")
        log(f"[bench kernels] {label}: gate_front_y, gate_stack and gate_pulses bit-equal to "
            f"their plain versions at the shapes it launched them on: {sorted(checked)}")
        if label in ("blf640", "blf160"):
            c = CASES[label].cfg
            geo = (c.decim, front_taps(c), c.win_length, c.dc_length)
            (x,) = [x for (k, _, build, *_), x in kernels.kept.items()
                    if k == "gate_front" and build == "y"]
            y_rows[label] = dict(y_report(label, x, geo, both, fmt),
                                 launches=got["front_y"] // runs_n)
        for k in total:
            total[k] += got[k]

    lines, got = bench_run("bench_scaling", ["--positions", str(SCALING_POSITIONS)])
    check(len(lines) == 1, f"bench_scaling: {len(lines)} lines")
    line = lines[0]
    check(line["device"] == name and line["power_limit_w"] is not None
          and (line["n_devices"], line["positions"]) == (1, SCALING_POSITIONS)
          and line["epcs"] == SCALING_EPCS,
          f"bench_scaling: {line['device']}, {line['n_devices']} devices, "
          f"{line['positions']} positions, {line['epcs']} EPCs")
    for key, n_time in (("1", 1), ("n", SCALING_POSITIONS)):
        want = {"gate_front": n_time, "gate_stack_stream": n_time, "gate_stack_segment": 0,
                "gate_scan": 0}
        check(line["launches"][key] == want,
              f"bench_scaling n_time={n_time}: {line['launches'][key]}, expected {want}")
    runs_n = (BENCH_DECODES + 1) * (1 + SCALING_POSITIONS)
    check(got == {"gate_front": runs_n, "front_y": runs_n, "front_full": 0, "stream": runs_n,
                  "segment": 0, "gate_scan": 0, "gate_pulses": runs_n}, f"bench_scaling: {got}")
    checked = kept_kernel_checks()
    log(f"[bench kernels] scaling: bit-equal at {sorted(checked)}")
    for k in total:
        total[k] += got[k]
    return total, y_rows


# Phase 6: compat mode.  Its stream, shards and live windows: the golden
# trace in 200,000-sample chunks; the bench capture (padded to a multiple of
# 8 x decim) at n_time 8 with a table of 256 a shard, as phase 18's; and
# tests/test_torch_live.py's compat loop (tag 27 seed 7, channel seed 1, 3
# round commands, 3 EPCs).
COMPAT_SHARDS = (8, 256)
COMPAT_LIVE_ROUNDS = 3


@contextlib.contextmanager
def plain_compat_chain():
    """While the block runs, the compat gate takes its plain version on the
    card (the PyTorch scans the port ran before the compat-gate kernel):
    dsp/gate.py's ``compat_gate_for_cfg`` swapped, for the decode's time
    before and after the kernel in one process."""
    from gen2_rfid_tpu_torch.dsp import gate
    from gen2_rfid_tpu_torch.kernels.compat_gate import compat_gate_plain

    kernel = gate.compat_gate_for_cfg
    gate.compat_gate_for_cfg = lambda amp, avg, cfg: compat_gate_plain(
        amp, avg, cfg.thresh_fraction, cfg.n_samples_pw // 2, cfg.n_samples_t1,
        cfg.num_pulses_command)
    try:
        yield
    finally:
        gate.compat_gate_for_cfg = kernel


def compat_row(label, amp, avg, args, both, fmt, reps=20, plain_reps=5, count_ops=True):
    """compat_gate at one shape, timed under both flushes beside its bound
    (amp and avg in, trig and pulses_at out: 13 bytes a sample; a multiply
    and two compares), its plain version on the card and one
    ``torch.cummax`` of an int32 row of the same length (the library call
    each of the plain version's scans is), and, with ``count_ops``, the
    device ops of a call from ``torch.profiler``, which must be its one
    kernel.  Returns the row, with the configuration the wrapper chose and
    its tile."""
    import torch

    from gen2_rfid_tpu_torch.kernels.compat_gate import (
        choose_config, compat_gate, compat_gate_plain, config_tile)

    n = amp.shape[0]
    config = choose_config(n, args[2])
    idx = torch.where(amp > avg * args[0], torch.arange(n, dtype=torch.int32, device=amp.device),
                      -1).to(torch.int32)
    t = both(lambda: compat_gate(amp, avg, *args), reps)
    pt = both(lambda: compat_gate_plain(amp, avg, *args), plain_reps)
    lt = both(lambda: torch.cummax(idx, 0), plain_reps)
    b, by = bound(13 * n, 3 * n)
    ops = None
    if count_ops:
        prof = device_profile(lambda: compat_gate(amp, avg, *args), reps=20, top=8,
                              label=f"profile compat_gate {label}", unit="call")
        ops = sum(r[1] for r in prof) // 20 if prof else None
        check(ops == 1, f"compat_gate at {label}: {ops} device ops a call, not its one kernel")
    log(f"[time] {label} compat_gate n={n} (configuration {config}, tile "
        f"{config_tile(config)}): {fmt(t)}, bound {b:.6f} ms ({by}), "
        f"{100 * b / t['read']:.1f}% of the read time; plain {fmt(pt)}; torch.cummax of an "
        f"int32 row {fmt(lt)}" + (f"; {ops} device op a call" if count_ops else ""))
    return {"n": n, "ms": t["write"], "ms_read": t["read"], "bound_ms": b, "bound_by": by,
            "share_read": b / t["read"], "plain_ms": pt["write"], "plain_ms_read": pt["read"],
            "library_ms": lt["write"], "library_ms_read": lt["read"], "kernels_a_call": ops,
            "config": config, "tile": config_tile(config)}


def compat_sweep(shapes, both):
    """compat_gate's configurations (threads a block, words a thread) timed
    at each shape, read flush (ms): {shape: {tile "TxW": ms}}, with the
    fastest and the wrapper's choice logged."""
    from gen2_rfid_tpu_torch.kernels.compat_gate import CONFIGS, choose_config, compat_gate

    out = {}
    for label, (amp, avg, args) in shapes.items():
        row = {}
        for config, (threads, words) in enumerate(CONFIGS):
            row[f"{threads}x{words}"] = both(
                lambda: compat_gate(amp, avg, *args, config=config), 20)["read"]
        best = min(row, key=row.get)
        chosen = "{}x{}".format(*CONFIGS[choose_config(amp.shape[0], args[2])])
        log(f"[compat_gate sweep] {label} n={amp.shape[0]}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()) + f" ms (read); fastest {best}, "
            f"the wrapper's {chosen} {row[chosen]:.4f}")
        out[label] = row
    return out


def profile_summary(rows, reps):
    """(device busy ms, device ops) a decode from ``device_profile``'s rows."""
    return (sum(r[0] for r in rows) / reps / 1e3, sum(r[1] for r in rows) // reps)


def phase_compat(dev, both, fmt, x2_g, x2_b, tr_g, iq_b, rng):
    """Phase 6: compat mode on the card.  The golden tuple (CUDA == CPU) and
    the bench capture 640 / 640, each through one launch of gate_front's full
    build and one of compat_gate; the golden trace streamed in chunks (equal
    to the batch decode), the bench capture at n_time 8 (equal to its single
    decode) and a live loop (equal to its CPU run), each gate through one
    compat_gate launch; compat_gate bit-equal to its plain version at
    golden (also 4 bytes past a 16-byte boundary), bench, fm0_16msps and
    every input of ``compat_cases`` at tiles of 32, 33 and the model's
    default, every configuration on an input drawn at random past 1,024 of
    its tiles, 200 launches alike, its tile model equal to it at golden and
    bench; its time beside its bound, its plain version and
    ``torch.cummax``, one device op a call, its configurations swept there
    and around the wrapper's cuts; the
    bench decode with the kernel and with the plain chain, in turns, timed
    and profiled.  Returns the numbers for the kernels line."""
    import numpy as np
    import torch

    from gen2_rfid_tpu_torch import kernels
    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.kernels.compat_gate import (
        CONFIGS, LIB, TILE, compat_cases, compat_gate, compat_gate_plain,
        compat_gate_tiles_plain, config_tile)
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.runtime.live import LiveReader
    from gen2_rfid_tpu_torch.runtime.stream import StreamDecoder
    from gen2_rfid_tpu_torch.sim.channel import SimTagChannel
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
    from gen2_rfid_tpu_torch.tools.live_scenes import DecodeLog, integer_fields
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

    x2_gd = x2_g.to(dev)
    cfg_gc = ReaderConfig(mode="compat")
    kernels.reset_launches()
    run_gc = decode_capture_planar(x2_gd, cfg_gc)
    torch.cuda.synchronize()
    got = launch_counts()
    log(f"[compat golden] launches {got}, tuple {golden_tuple(run_gc[0])}")
    check(golden_tuple(run_gc[0]) == GOLDEN, "compat golden tuple not reproduced on CUDA")
    check(got == compat_counts(1), "compat golden: not one launch of gate_front's full build "
                                   "and one of compat_gate")
    same_as_cpu("compat golden", run_gc, decode_capture_planar(x2_g, cfg_gc, device="cpu"))
    cfg_bc = ReaderConfig(mode="compat", max_events=1536)
    kernels.reset_launches()
    st_bc, _ = decode_capture_planar(x2_b, cfg_bc)
    torch.cuda.synchronize()
    compat_launches = launch_counts()
    log(f"[compat bench] launches {compat_launches}")
    check(int(st_bc.n_epc_correct) == 640 and int(st_bc.tag_reads[27]) == 640,
          f"compat bench decode: {int(st_bc.n_epc_correct)} EPCs, expected 640")
    check(compat_launches == compat_counts(1),
          "compat bench decode: gate_front's full build and compat_gate must run once, "
          "gate_stack not")

    # The stream's chunks, the shards and the live windows: one compat_gate
    # launch a gate.
    sd = StreamDecoder(cfg_gc, chunk_adc=200_000)
    kernels.reset_launches()
    st_s, total = sd.decode(iter(np.array_split(tr_g.iq, 7)))
    torch.cuda.synchronize()
    stream_launches = launch_counts()
    log(f"[compat stream golden] {sd._chunk_no} chunks, launches {stream_launches}")
    check(stream_launches == compat_counts(sd._chunk_no),
          "compat stream: one gate_front (full build) and one compat_gate launch a chunk")
    check(total == tr_g.iq.size and golden_tuple(st_s) == GOLDEN,
          "compat stream: golden tuple not reproduced")
    for f in st_s._fields:
        check(torch.equal(getattr(st_s, f), getattr(run_gc[0], f)),
              f"compat stream golden InventoryStats.{f} != the batch decode's")
    n_time, eps = COMPAT_SHARDS
    x2_p = to_planar(np.pad(iq_b, (0, (-iq_b.size) % (n_time * cfg_bc.decim)))).to(dev)
    shard_launches, _ = sharded_run("compat bench", x2_p, cfg_bc, n_time, eps,
                                    decode_capture_planar(x2_p, cfg_bc), 640, dev,
                                    want=compat_counts(n_time))
    del x2_p
    runs = {}
    for device in ("cuda", "cpu"):
        reader = LiveReader(cfg_gc, device=device)
        decodes = DecodeLog(reader)
        kernels.reset_launches()
        st_l = reader.run_inventory(
            SimTagChannel(cfg_gc, [Tag.with_id(27, seed=7)], seed=1), COMPAT_LIVE_ROUNDS)
        torch.cuda.synchronize()
        runs[device] = (st_l, len(decodes.calls), launch_counts())
    (st_l, n_dec, live_launches), (st_lc, _, _) = runs["cuda"], runs["cpu"]
    log(f"[compat live] {st_l.n_queries} queries, {st_l.n_epc_correct} EPCs; {n_dec} window "
        f"decodes, launches {live_launches}")
    check(live_launches == compat_counts(n_dec),
          "compat live: one gate_front (full build) and one compat_gate launch a window")
    check(st_l.n_epc_correct == COMPAT_LIVE_ROUNDS, "compat live: not an EPC a round")
    a, b = integer_fields(st_l), integer_fields(st_lc)
    check(a == b, f"compat live: card != CPU on {[k for k in a if a[k] != b[k]]}")
    # The largest window the loop gave the kernel (main keeps its inputs
    # through the phase; every window is one tile).
    live = max((x for (name, shape, *_), x in kernels.kept.items()
                if name == "compat_gate" and shape[1] <= TILE), key=lambda x: x.shape[1])

    # The kernel against its plain version on the card, and its tile model.
    check([LIB.compat_gate_tile(i) for i in range(LIB.compat_gate_configs())]
          == [config_tile(i) for i in range(len(CONFIGS))],
          "compat_gate's configurations differ from the wrapper's")
    win = torch.tensor(float(cfg_gc.win_length), device=dev)
    args = (cfg_gc.thresh_fraction, cfg_gc.n_samples_pw // 2, cfg_gc.n_samples_t1,
            cfg_gc.num_pulses_command)
    _, amp_g, s_g, _ = gate_front_for_cfg(x2_gd, cfg_gc)
    _, amp_b, s_b, _ = gate_front_for_cfg(x2_b, cfg_bc)
    amp_g, avg_g, amp_b, avg_b = amp_g, s_g / win, amp_b, s_b / win
    # The fm0_16msps capture (phase 16's) through gate_front's full build:
    # a T1 window of 3,840 samples, the halo's widest.
    _, kw16, rounds16 = HIGH_RATES[1]
    c16 = ReaderConfig(**kw16)
    tr16 = synthesize_inventory(c16, [Tag.with_id(27, seed=7)], n_rounds=rounds16, seed=2)
    x2_16 = to_planar(np.concatenate([tr16.iq] * 2)).to(dev)
    _, amp_16, s_16, _ = gate_front_for_cfg(x2_16, c16)
    avg_16 = s_16 / torch.tensor(float(c16.win_length), device=dev)
    args16 = (c16.thresh_fraction, c16.n_samples_pw // 2, c16.n_samples_t1,
              c16.num_pulses_command)
    del x2_16
    # Drawn decisions past 1,024 tiles of the widest configuration: every
    # configuration looks back over windows of 256 tiles, in rounds.
    n_d = 1024 * max(config_tile(i) for i in range(len(CONFIGS))) + 3
    drawn = torch.from_numpy(rng.choice([0.0, 0.5, 1.0], n_d).astype(np.float32)).to(dev)
    ones_d = torch.ones(n_d, device=dev)
    # The golden input 4 bytes past a 16-byte boundary.
    buf = torch.empty(2 * amp_g.numel() + 2, device=dev)
    amp_u, avg_u = buf[1:amp_g.numel() + 1], buf[amp_g.numel() + 2:]
    amp_u.copy_(amp_g)
    avg_u.copy_(avg_g)
    inputs = [("golden", amp_g, avg_g, args), ("bench", amp_b, avg_b, args),
              ("fm0_16msps", amp_16, avg_16, args16),
              ("golden 4 bytes past 16", amp_u, avg_u, args)]
    for tile in (32, 33, TILE):
        inputs += [(f"{label} (tile {tile})", *rest) for label, *rest in compat_cases(tile)]
    err, n_trig = 0, 0
    for label, amp, avg, a_ in inputs:
        amp, avg = amp.to(dev), avg.to(dev)
        trig, pulses = compat_gate(amp, avg, *a_)
        want_t, want_p = compat_gate_plain(amp, avg, *a_)
        torch.cuda.synchronize()
        n_bad = int((trig != want_t).sum()) + int((pulses != want_p).sum())
        check(n_bad == 0, f"compat_gate differs from its plain version on {label}: "
                          f"{n_bad} of {2 * amp.numel()} outputs")
        err = max(err, int((pulses - want_p).abs().max()) if pulses.numel() else 0)
        n_trig += int(want_t.sum())
        if label in ("golden", "bench"):
            m_t, m_p = compat_gate_tiles_plain(amp, avg, *a_)
            check(torch.equal(m_t, trig.cpu()) and torch.equal(m_p, pulses.cpu()),
                  f"compat_gate's tile model differs from the kernel on {label}")
            log(f"[compat_gate {label}] kernel == plain == tile model, n={amp.numel()}, "
                f"{int(want_t.sum())} triggers")
    # Every configuration on the drawn input, and 200 launches of the
    # wrapper's on a drawn input of the bench length: the same bits each time.
    want_t, want_p = compat_gate_plain(drawn, ones_d, 0.5, 2, 5, 3)
    for config in range(len(CONFIGS)):
        trig, pulses = compat_gate(drawn, ones_d, 0.5, 2, 5, 3, config=config)
        n_bad = int((trig != want_t).sum()) + int((pulses != want_p).sum())
        check(n_bad == 0, f"compat_gate configuration {config} differs from its plain version "
                          f"on {n_d} drawn samples: {n_bad} outputs")
    n_r = amp_b.numel()
    rep_amp, rep_avg = drawn[:n_r].contiguous(), ones_d[:n_r]
    want_t, want_p = compat_gate_plain(rep_amp, rep_avg, 0.5, 2, 5, 3)
    n_bad = 0
    for _ in range(200):
        trig, pulses = compat_gate(rep_amp, rep_avg, 0.5, 2, 5, 3)
        n_bad += int((trig != want_t).sum()) + int((pulses != want_p).sum())
    check(n_bad == 0, f"compat_gate: 200 launches at n={n_r} differ from the plain version "
                      f"in {n_bad} outputs")
    del drawn, ones_d, want_t, want_p
    log(f"[compat_gate] bit-equal to its plain version on {len(inputs)} inputs "
        f"({n_trig} triggers): golden (also 4 bytes past 16), bench, fm0_16msps and "
        f"compat_cases at tiles 32, 33 and {TILE}; every configuration on {n_d} drawn "
        f"samples; 200 launches at n={n_r} the same bits")

    # Times: bench, golden, the largest live window and fm0_16msps; the
    # configurations swept at each.
    shapes = {"bench": (amp_b, avg_b, args), "golden": (amp_g, avg_g, args),
              "live": (live[0], live[1], args), "fm0_16msps": (amp_16, avg_16, args16)}
    rows = {label: compat_row("live window" if label == "live" else label, *shape, both, fmt,
                              reps=50 if label == "live" else 20)
            for label, shape in shapes.items()}
    sweep = compat_sweep(shapes, both)
    # Around choose_config's cuts: bench prefixes on both sides of 2^20
    # samples at nt1 96, and FM0 captures at 4 and 8 Msps, decim 1 (nt1 960
    # and 1,920, on both sides of 1,024; 20 rounds tiled twice).
    cuts = {f"bench[:{m}]": (amp_b[:m].contiguous(), avg_b[:m].contiguous(), args)
            for m in (1 << 19, 1 << 20, 3 << 19)}
    for label, kw in (("fm0_4msps", dict(adc_rate=4e6, decim=1, max_events=256)),
                      HIGH_RATES[0][:2]):
        ck = ReaderConfig(**kw)
        trk = synthesize_inventory(ck, [Tag.with_id(27, seed=7)], n_rounds=20, seed=2)
        _, amp_k, s_k, _ = gate_front_for_cfg(to_planar(np.concatenate([trk.iq] * 2)).to(dev), ck)
        cuts[label] = (amp_k, s_k / torch.tensor(float(ck.win_length), device=dev),
                       (ck.thresh_fraction, ck.n_samples_pw // 2, ck.n_samples_t1,
                        ck.num_pulses_command))
    sweep.update(compat_sweep(cuts, both))
    del amp_g, avg_g, amp_b, avg_b, s_g, s_b, amp_16, avg_16, s_16, shapes, cuts

    # The bench decode with the kernel and with the plain chain, in turns.
    decode_ms = {"plain_chain": [], "kernel": []}
    for side in ("plain_chain", "kernel", "kernel", "plain_chain"):
        with plain_compat_chain() if side == "plain_chain" else contextlib.nullcontext():
            kernels.reset_launches()
            decode_ms[side].append(cuda_ms(lambda: decode_capture_planar(x2_b, cfg_bc), 7))
            # cuda_ms runs 2 untimed and 7 timed decodes.
            check(kernels.launches["compat_gate"] == (side == "kernel") * 9,
                  f"compat bench decode ({side}): compat_gate launches "
                  f"{kernels.launches['compat_gate']}")
    log(f"[compat bench] decode ms, in turns (plain chain, kernel, kernel, plain chain): "
        f"plain chain {decode_ms['plain_chain']}, kernel {decode_ms['kernel']} for "
        f"{x2_b.shape[1]} samples, 640 / 640 EPCs")
    profile = {}
    with plain_compat_chain():
        profile["plain_chain"] = profile_summary(device_profile(
            lambda: decode_capture_planar(x2_b, cfg_bc), top=6,
            label="profile compat, plain chain"), 3)
    profile["kernel"] = profile_summary(device_profile(
        lambda: decode_capture_planar(x2_b, cfg_bc), top=8, label="profile compat"), 3)
    return {"launches": compat_launches, "stream": stream_launches["compat_gate"],
            "sharded": shard_launches["compat_gate"], "live": live_launches["compat_gate"],
            "err": err, "rows": rows, "sweep": sweep, "decode_ms": decode_ms,
            "profile": profile}


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
    from gen2_rfid_tpu_torch.dsp.filters import magnitude, moving_sum
    from gen2_rfid_tpu_torch.kernels import _build
    from gen2_rfid_tpu_torch.kernels.gate_front import (
        BLOCK_Y, BLOCK_Y_Y, front_taps, gate_front, gate_front_for_cfg, gate_front_plain,
        gate_front_y, gate_front_y_plain)
    from gen2_rfid_tpu_torch.kernels.gate_scan import (
        dense_edges, gate_scan, gate_scan_edges_plain, gate_scan_for_cfg,
        gate_scan_plain, pulse_train, random_runs)
    from gen2_rfid_tpu_torch.kernels.gate_stack import (
        BLF640, burst_capture, check_arith, gate_stack_flags, gate_stack_plain,
        gate_stack_shape, segment_cases, stream_cases)
    from gen2_rfid_tpu_torch.kernels.probe import probe, probe_plain
    from gen2_rfid_tpu_torch.runtime.inventory import (
        decode_capture_planar, to_planar)
    from gen2_rfid_tpu_torch.runtime.stats import format_results
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import golden_trace, synthesize_inventory
    from gen2_rfid_tpu_torch.tools import gate_sums_experiment
    from gen2_rfid_tpu_torch.utils.timing import cuda_ms

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

    # ---- phase 0: the execution probe, before everything else ----
    rng = np.random.default_rng(1)
    err_probe = 0.0
    for shape in [(8, 128), (1,), (3, 7), (1 << 20,)]:
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        got, want = probe(x), probe_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"probe kernel != plain at {shape}")
        err_probe = max(err_probe, float((got - want).abs().max()))
    log("[probe] kernel == plain bit for bit at (8, 128), (1,), (3, 7), (1048576,)")

    cfg0 = ReaderConfig()
    decim, taps = cfg0.decim, front_taps(cfg0)
    win, dcw = cfg0.win_length, cfg0.dc_length
    pw_half, nt1, frac = cfg0.n_samples_pw // 2, cfg0.n_samples_t1, cfg0.thresh_fraction

    # ---- the bench-size capture (bench.py's workload) ----
    cfg_b = ReaderConfig(max_events=1536)
    tr_b = synthesize_inventory(cfg_b, [Tag.with_id(27, seed=7)], n_rounds=BENCH_ROUNDS, seed=2)
    reps_tile = BENCH_TILES
    iq_b = np.concatenate([tr_b.iq] * reps_tile)
    x2_b = to_planar(iq_b).to(dev)
    n_b = x2_b.shape[1]
    ny_b = n_b // decim
    expected_b = tr_b.expected_epc_pass * reps_tile
    log(f"[bench capture] N={n_b} samples, Ny={n_b // decim}, "
        f"expected EPCs {expected_b}")

    # ---- phase 1: kernels against their plain versions ----
    # gate_front: bit for bit, at the bench shape, on noise, and at every
    # ragged end of its register blocking (a thread sums 4 outputs: ny % 4 =
    # 1..3, ny < 4, ny below the 99-sample halo) for three tiles.
    err_front = 0.0
    cases = [("bench", x2_b, BLOCK_Y)]
    for n, blk in [(40961, 512), (9999, 64), (10240, 2048), (4099, 512), (7, 512), (3, 512)]:
        x = rng.normal(size=(2, n)).astype(np.float32)
        cases.append((f"noise n={n}", torch.from_numpy(x).to(dev), blk))
    for blk in sorted({BLOCK_Y, 512, 1024}):
        for ny_r in [16000 + m for m in range(1, 4)] + [3, 50]:
            n = decim * ny_r + ny_r % decim
            x = rng.normal(size=(2, n)).astype(np.float32)
            cases.append((f"ny={ny_r}", torch.from_numpy(x).to(dev), blk))
    # The slab's copies take any 4-byte alignment of x2.
    x_odd = torch.from_numpy(rng.normal(size=(2, 40963)).astype(np.float32))
    x_odd = torch.empty(x_odd.numel() + 1, device=dev)[1:].view(2, 40963).copy_(x_odd)
    cases.append(("noise n=40963 at 4 bytes past 16", x_odd, BLOCK_Y))
    y2_bench = None
    for label, x2, blk in cases:
        got = gate_front(x2, decim, taps, win, dcw, block_y=blk)
        want = gate_front_plain(x2, decim, taps, win, dcw)
        torch.cuda.synchronize()
        diffs = [float((g - w).abs().max()) if g.numel() else 0.0
                 for g, w in zip(got, want)]
        log(f"[gate_front {label} block={blk}] max|kernel-plain| "
            f"y={diffs[0]:.3g} amp={diffs[1]:.3g} avgsum={diffs[2]:.3g} "
            f"dcsum={diffs[3]:.3g}")
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"gate_front is not bit-equal to its plain version on {label}")
        err_front = max(err_front, *diffs)
        if label == "bench":
            y2_bench = got[0]
    # gate_front's y build: bit for bit against its plain version and the
    # full build's y, at the bench shape, at every ragged end of its register
    # blocking (a thread sums 8 outputs: ny % 8 = 1..7, ny < 8) for three
    # tiles, on the unaligned input, and at other decimations and filter
    # lengths (the walk with runtime bounds: the Miller, blf640, 8 and 16
    # Msps widths among them).
    err_y = 0.0
    y_cases = [("bench", x2_b, decim, taps, BLOCK_Y_Y, y2_bench),
               ("noise n=40963 at 4 bytes past 16", x_odd, decim, taps, BLOCK_Y_Y, None)]
    for blk in (BLOCK_Y_Y, 512, 64):
        for ny_r in [16000 + m for m in range(1, 8)] + [3, 7]:
            n = decim * ny_r + ny_r % decim
            x = rng.normal(size=(2, n)).astype(np.float32)
            y_cases.append((f"ny={ny_r}", torch.from_numpy(x).to(dev), decim, taps, blk, None))
    for d, t in ((1, 6), (2, 12), (2, 6), (1, 100), (1, 200), (3, 7), (1, 1), (2, 9)):
        for n, blk in ((30001, BLOCK_Y_Y), (30001, 256), (t + 2, BLOCK_Y_Y)):
            x = rng.normal(size=(2, n)).astype(np.float32)
            y_cases.append((f"decim {d} taps {t} n={n}", torch.from_numpy(x).to(dev), d, t, blk,
                            None))
    for label, x2, d, t, blk, full_y in y_cases:
        got = gate_front_y(x2, d, t, block_y=blk)
        want = gate_front_y_plain(x2, d, t)
        if full_y is None:
            full_y = gate_front(x2, d, t, win, dcw)[0]
        torch.cuda.synchronize()
        diff = float((got - want).abs().max()) if got.numel() else 0.0
        check(torch.equal(got, want) and torch.equal(got, full_y),
              f"gate_front_y is not bit-equal to its plain version and the full build's y on "
              f"{label} block={blk} (max|kernel-plain| {diff:.3g})")
        err_y = max(err_y, diff)
    log(f"[gate_front_y] bit-equal to its plain version and to the full build's y on "
        f"{len(y_cases)} inputs: the bench shape, ny % 8 = 1..7 and ny < 8 at block_y "
        f"{BLOCK_Y_Y}, 512 and 64, an input 4 bytes past 16, decim/taps 1/6, 2/12, 2/6, "
        f"1/100, 1/200, 3/7, 1/1, 2/9")
    # gate_stack: flags exactly equal (run 0: the automatic run) on the bench
    # y, noise, every input the CPU models are held to, bench-size lengths on
    # a run boundary and one past it; every width but ReaderConfig's among
    # the models' inputs runs the segment kernel.
    arith = check_arith()
    log(f"[gate_stack arithmetic] the stream's fast sqrt and division by 100 against "
        f"__fsqrt_rn / __fdiv_rn on every float of their range (0, [2^-100, FLT_MAX]): "
        f"{arith}")
    check(arith["sqrt_differs"] == 0 and arith["div_differs"] == 0,
          "the stream kernel's root or division is not the IEEE one")
    err_stack = 0
    stack_geo = (win, pw_half, nt1, frac)
    stack_cases = [("bench y", y2_bench, stack_geo, 0)]
    for n, run in [(40961, 32), (9999, 8), (10240, 128), (150, 0), (1, 0)]:
        y = rng.normal(size=(2, n)).astype(np.float32)
        stack_cases.append((f"noise n={n}", torch.from_numpy(y).to(dev), stack_geo, run))
    stack_cases += [(label, y2.to(dev), geo, run)
                    for label, y2, geo, run in stream_cases() + segment_cases()]
    run_b = gate_stack_shape(ny_b, win, pw_half, nt1)["run"]
    for ny_r in (32 * run_b * 2000, 32 * run_b * 2000 + 1):
        stack_cases.append((f"bursts ny={ny_r} (run boundary)", burst_capture(ny_r, 3).to(dev),
                            stack_geo, 0))
    y2_blf = burst_capture(ny_b, 5).to(dev)
    stack_cases.append(("blf640 bursts at the bench Ny", y2_blf, BLF640, 0))
    for label, y2, geo, run in stack_cases:
        want = gate_stack_plain(y2, *geo)
        got = gate_stack_flags(y2, *geo, run=run)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        log(f"[gate_stack {label} run={run}] flags differing: {n_bad} of {got.numel()}; "
            f"set bits {int((want != 0).sum())}")
        check(n_bad == 0, f"gate_stack flags differ from the plain version on {label}")
        if got.numel():
            err_stack = max(err_stack, int((got - want).abs().max()))

    # From here to phase 18 the kernels keep their inputs, and after each
    # phase (hold_kept) gate_front's two builds, gate_stack, compat_gate and
    # gate_pulses are held bit for bit against their plain versions on every
    # shape and geometry the phase launched them on.
    kernels.keep_inputs(True)

    # ---- phase 2: the golden trace on CUDA, against a CPU run ----
    cfg_g = ReaderConfig()
    tr_g = golden_trace(cfg_g)
    x2_g = to_planar(tr_g.iq)
    kernels.reset_launches()
    st_g, dec_g = decode_capture_planar(x2_g.to(dev), cfg_g)
    torch.cuda.synchronize()
    golden_launches = launch_counts()
    log(format_results(st_g))
    log(f"[golden] launches {golden_launches}")
    check(golden_tuple(st_g) == GOLDEN, "golden tuple not reproduced on CUDA")
    check(golden_launches == counts_of(1, 1),
          "golden decode: not one launch of gate_front's y build and one of gate_stack")
    st_c, dec_c = decode_capture_planar(x2_g, cfg_g, device="cpu")
    same_as_cpu("golden", (st_g, dec_g), (st_c, dec_c))
    x2_gd = x2_g.to(dev)
    golden_ms = cuda_ms(lambda: decode_capture_planar(x2_gd, cfg_g), 11)
    log(f"[golden] decode {golden_ms:.3f} ms for {x2_g.shape[1]} samples "
        f"({x2_g.shape[1] / golden_ms / 1e3:.1f} Msamples/s)")

    # ---- phase 3: the main path at bench size ----
    kernels.reset_launches()
    st_b, _ = decode_capture_planar(x2_b, cfg_b)
    torch.cuda.synchronize()
    main_launches = launch_counts()
    log(format_results(st_b))
    log(f"[bench] launches {main_launches}")
    check(int(st_b.n_epc_correct) == expected_b == 640
          and int(st_b.tag_reads[27]) == 640,
          f"bench decode: {int(st_b.n_epc_correct)} EPCs, expected {expected_b}")
    check(main_launches == counts_of(1, 1),
          "bench decode: not one launch of gate_front's y build and one of gate_stack")
    bench_ms = cuda_ms(lambda: decode_capture_planar(x2_b, cfg_b), 11)
    log(f"[bench] decode {bench_ms:.3f} ms for {n_b} samples "
        f"({n_b / bench_ms / 1e3:.1f} Msamples/s, "
        f"{expected_b / bench_ms * 1e3:.0f} EPC/s)")

    # ---- phase 4: per-kernel time at the bench shape ----
    # Every kernel is timed under both flushes of cuda_ms: "write" (zero
    # the 256 MB buffer: L2 left full of dirty lines) and "read" (sum it:
    # L2 left clean).
    ny = ny_b
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def both(fn, reps):
        return {by: cuda_ms(fn, reps, flush, flush_by=by) for by in ("write", "read")}

    def fmt(t):
        return f"{t['write']:.4f} (write) / {t['read']:.4f} (read) ms"

    # The tile, by measurement: sizes where a tile's groups of 4 y fill
    # whole passes of a block's 256 threads (924, 1948) beside powers of 2.
    sweep = {}
    for blk in (512, 768, 924, 1024, 1948):
        sweep[blk] = cuda_ms(lambda blk=blk: gate_front(x2_b, decim, taps, win, dcw, block_y=blk),
                             20, flush, flush_by="read")
        log(f"[gate_front sweep] block_y={blk}: {sweep[blk]:.4f} ms (read flush)")
    best = min(sweep, key=sweep.get)
    log(f"[gate_front sweep] fastest block_y={best} ({sweep[best]:.4f} ms); "
        f"the wrapper's default block_y={BLOCK_Y} ({sweep[BLOCK_Y]:.4f} ms)")
    front_t = both(lambda: gate_front(x2_b, decim, taps, win, dcw), 20)
    # A dc window of 47 (one add fewer a plane and output, the same halo)
    # runs the kernel built with runtime loop bounds: what a configuration
    # other than ReaderConfig's widths pays.
    front_rt_t = both(lambda: gate_front(x2_b, decim, taps, win, dcw - 1), 20)
    front_plain_t = both(lambda: gate_front_plain(x2_b, decim, taps, win, dcw), 5)
    # gate_stack: the warp stream at its automatic run, its run swept at the
    # bench and golden shapes, and the segment kernel (every other width) at
    # the blf640 widths.
    y2_gold = gate_front_for_cfg(x2_g.to(dev), cfg_g)[0]
    for label, y2s, geo in (("bench", y2_bench, stack_geo), ("golden", y2_gold, stack_geo)):
        shp = gate_stack_shape(y2s.shape[1], *geo[:3])
        waves = shp["grid"] / (shp["blocks_per_sm"] * shp["sms"])
        log(f"[gate_stack shape] {label} Ny={y2s.shape[1]} widths {geo[:3]}: {shp}; "
            f"{waves:.2f} waves, {shp['blocks_per_sm'] * shp['threads'] // 32} "
            f"resident warps an SM of 64")
        runs = {}
        for run in (5, 13, 21, 29, 37, 53, 61, 125):
            runs[run] = cuda_ms(lambda run=run: gate_stack_flags(y2s, *stack_geo, run=run), 20,
                                flush, flush_by="read")
        log(f"[gate_stack run sweep] {label}: " + ", ".join(
            f"run={r}: {t:.4f}" for r, t in runs.items()) + " ms (read flush); "
            f"fastest run={min(runs, key=runs.get)}")
    stack_t = both(lambda: gate_stack_flags(y2_bench, *stack_geo), 20)
    # No flush: the 23.3 MB the kernel moves stay in the 50 MB L2, so what
    # this saves against the read flush is what DRAM costs it.
    stack_warm_ms = cuda_ms(lambda: gate_stack_flags(y2_bench, *stack_geo), 20)
    stack_gold_t = both(lambda: gate_stack_flags(y2_gold, *stack_geo), 20)
    stack_plain_t = both(lambda: gate_stack_plain(y2_bench, *stack_geo), 5)
    # Bytes: each input read once, each output written once.
    front_b, front_by = front_bound(n_b, ny, taps, win, dcw)
    stack_bytes = 4 * (2 * ny) + 4 * ny
    stack_b, stack_by = stack_bound(ny, win)
    log(f"[time] gate_front kernel {fmt(front_t)}, plain {fmt(front_plain_t)}, "
        f"bound {front_b:.4f} ms ({front_by}); runtime loop bounds (dc window "
        f"{dcw - 1}) {fmt(front_rt_t)}")
    log(f"[time] gate_stack stream kernel {fmt(stack_t)}, {stack_warm_ms:.4f} ms with its "
        f"data in L2 (no flush), plain {fmt(stack_plain_t)}, bound {stack_b:.4f} ms "
        f"({stack_by}); achieved {stack_bytes / stack_t['read'] / 1e6:.0f} GB/s (read flush)")
    log(f"[time] gate_stack at golden Ny={y2_gold.shape[1]}: stream {fmt(stack_gold_t)}")
    segment_rows = {"blf640": segment_report("blf640 bursts", y2_blf, BLF640, both, fmt, flush)}
    # gate_front's y build at the bench shape, its tile swept, and at the
    # golden shape, beside its bound, its plain version and conv1d.
    y_rows = {"bench": y_report("bench", x2_b, (decim, taps, win, dcw), both, fmt,
                                full_y=y2_bench, sweep=flush),
              "golden": y_report("golden", x2_g.to(dev), (decim, taps, win, dcw), both, fmt,
                                 full_y=y2_gold)}
    # gate_pulses at the bench shape and at the benchmark cell's Ny, 46.6 M
    # (the bench flags 24 times over: 46,580,640 of the cell's 46,580,659).
    flags_b = gate_stack_flags(y2_bench, *stack_geo)
    pulse_rows = {"bench": pulses_row("bench", flags_b, cfg_b, both, fmt),
                  "cell": pulses_row("cell Ny", flags_b.repeat(24), cfg_b, both, fmt)}
    hold_kept("phases 2-4")

    # ---- phase 5: where the bench decode's time goes ----
    stage_breakdown(x2_b, cfg_b)
    device_profile(lambda: decode_capture_planar(x2_b, cfg_b))

    # ---- phase 6: compat mode ----
    compat = phase_compat(dev, both, fmt, x2_g, x2_b, tr_g, iq_b, rng)
    compat_launches = compat["launches"]

    # ---- phase 7: exact_gate=True through the gate-scan kernel ----
    win_t = torch.tensor(float(win), dtype=torch.float32, device=dev)
    npc, rn16w, epcw = cfg0.num_pulses_command, cfg0.rn16_window, cfg0.epc_window
    cfg_args = (frac, pw_half, nt1, npc, rn16w, epcw)
    _, amp_g, avgsum_g, _ = gate_front_for_cfg(x2_gd, cfg_g)
    scan_cases = [("golden", amp_g, avgsum_g / win_t, cfg_args, None)]
    for n in (40961, 9999, 4096, 4097, 1):
        y = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32) * 0.3
                             + np.array([[1.0], [0.5]], np.float32)).to(dev)
        a = magnitude(y[0], y[1])
        scan_cases.append((f"noise n={n}", a, moving_sum(a, win) / win_t, cfg_args, None))
    # Dense edges (about one every other sample, the walk's worst case) at
    # lengths that are not multiples of 32 or 1024, with the configuration's
    # arguments and with arguments that trigger often; and a capture of ties.
    for n in (100003, 1025, 33):
        a, v = dense_edges(n, seed=n)
        a, v = a.to(dev), v.to(dev)
        scan_cases.append((f"dense edges n={n}", a, v, cfg_args, None))
        scan_cases.append((f"dense edges n={n} triggering", a, v, (0.75, 0, 0, 0, 1, 3), None))
    tie = torch.ones(5000, device=dev)
    scan_cases.append(("all ties n=5000", tie, tie / frac, cfg_args, None))
    # Random runs with short windows: the walk resumes after windows that
    # end in every state.
    for seed in range(8):
        a, v, args = random_runs(seed)
        scan_cases.append((f"random runs seed={seed}", a.to(dev), v.to(dev), args, None))
    # Synthetic trains with known triggers on word and chunk ends and on the
    # last sample, windows of one sample and windows across chunk edges.
    for n, w16, wepc in ((40961, 1, 1), (40961, 1, 37), (20481, 40, 4100),
                         (12289, 33, 64), (4097, 5, 3), (4096, 1, 1)):
        a, v, targets = pulse_train(n, 2, 5, 3, w16, wepc, seed=n)
        scan_cases.append((f"pulse train n={n} windows {w16}/{wepc}", a.to(dev), v.to(dev),
                           (0.5, 2, 5, 3, w16, wepc), targets))
    err_scan = 0
    for label, a, v, args, targets in scan_cases:
        trig, pulses = gate_scan(a, v, *args)
        want_t, want_p = gate_scan_plain(a, v, *args)
        torch.cuda.synchronize()
        n_bad = int((trig != want_t).sum()) + int((pulses != want_p).sum())
        log(f"[gate_scan {label}] outputs differing: {n_bad} of {2 * a.numel()}; "
            f"triggers {int(want_t.sum())}")
        check(n_bad == 0, f"gate_scan differs from its plain version on {label}")
        check(targets is None or trig.nonzero().flatten().tolist() == targets,
              f"gate_scan missed the planned triggers on {label}")
        err_scan = max(err_scan, int((pulses - want_p).abs().max()))
    for mode in ("native", "compat"):
        c = ReaderConfig(mode=mode)
        st_e, _ = decode_capture_planar(x2_gd, c, exact_gate=True)
        st_d, _ = decode_capture_planar(x2_gd, c)
        for f in st_e._fields:
            check(torch.equal(getattr(st_e, f), getattr(st_d, f)),
                  f"{mode} golden InventoryStats.{f}: exact gate != default gate")
        log(f"[exact golden {mode}] stats equal to the default gate's, "
            f"tuple {golden_tuple(st_e)}")
    kernels.reset_launches()
    st_be, _ = decode_capture_planar(x2_b, cfg_b, exact_gate=True)
    torch.cuda.synchronize()
    exact_launches = launch_counts()
    log(f"[exact bench] launches {exact_launches}")
    check(int(st_be.n_epc_correct) == 640 and int(st_be.tag_reads[27]) == 640,
          f"exact-gate bench decode: {int(st_be.n_epc_correct)} EPCs, expected 640")
    check(exact_launches == counts_of(1, gate_scan=1, build="full"),
          "exact-gate bench decode: gate_front's full build and gate_scan must run once, "
          "gate_stack not")
    exact_ms = cuda_ms(lambda: decode_capture_planar(x2_b, cfg_b, exact_gate=True), 5)
    log(f"[exact bench] decode {exact_ms:.3f} ms for {n_b} samples "
        f"({n_b / exact_ms / 1e3:.1f} Msamples/s), 640 / 640 EPCs")
    device_profile(lambda: decode_capture_planar(x2_b, cfg_b, exact_gate=True), top=6,
                   label="profile exact")
    _, amp_b, avgsum_b, _ = gate_front_for_cfg(x2_b, cfg_b)
    avg_b = avgsum_b / win_t
    scan_t = both(lambda: gate_scan_for_cfg(amp_b, avg_b, cfg_b), 5)
    got_t, got_p = gate_scan_for_cfg(amp_b, avg_b, cfg_b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_t, want_p = gate_scan_plain(amp_b, avg_b, frac, pw_half, nt1, npc, rn16w, epcw)
    torch.cuda.synchronize()
    scan_plain_ms = (time.perf_counter() - t0) * 1e3
    n_bad = int((got_t != want_t).sum()) + int((got_p != want_p).sum())
    check(n_bad == 0, "gate_scan differs from its plain version at the bench shape")
    # Bytes: amp and avg in, trig (1 byte) and pulses_out (4) out.
    # Operations: a multiply and two compares per sample.
    scan_bound, scan_by = bound((4 + 4 + 1 + 4) * ny, 3 * ny)
    log(f"[time] gate_scan kernel {fmt(scan_t)}, plain {scan_plain_ms:.1f} ms "
        f"(host loop), bound {scan_bound:.4f} ms ({scan_by})")
    # The walk's serial steps (one per edge or trigger), from the kernel's
    # Python model, which must give the plain version's outputs too.
    for label, a, v in (("golden", amp_g, avgsum_g / win_t), ("bench", amp_b, avg_b)):
        m_t, m_p, steps = gate_scan_edges_plain(a.cpu(), v.cpu(), *cfg_args)
        p_t, p_p = gate_scan_plain(a.cpu(), v.cpu(), *cfg_args)
        check(torch.equal(m_t, p_t) and torch.equal(m_p, p_p),
              f"the edge-walk model differs from the plain FSM on {label}")
        log(f"[gate_scan walk] {label}: {steps} serial steps for {a.numel()} samples "
            f"({int(m_t.sum())} triggers); model == plain")
    # Bench-size dense edges: the walk's worst case, one step per edge.
    amp_d, avg_d = dense_edges(ny, seed=3)
    _, _, steps_d = gate_scan_edges_plain(amp_d, avg_d, *cfg_args)
    amp_d, avg_d = amp_d.to(dev), avg_d.to(dev)
    got_t, got_p = gate_scan_for_cfg(amp_d, avg_d, cfg_b)
    want_t, want_p = gate_scan_plain(amp_d, avg_d, *cfg_args)
    torch.cuda.synchronize()
    n_bad = int((got_t != want_t).sum()) + int((got_p != want_p).sum())
    check(n_bad == 0, "gate_scan differs from its plain version on bench-size dense edges")
    scan_dense_t = both(lambda: gate_scan_for_cfg(amp_d, avg_d, cfg_b), 5)
    log(f"[time] gate_scan on dense edges, Ny={ny}: kernel {fmt(scan_dense_t)} for "
        f"{steps_d} serial steps; kernel == plain")

    # ---- phase 8: the optional FM0 stages on the golden trace ----
    def native_path_run(label, x2, c, once=False):
        """One decode with the counts set to 0 just before and read just
        after: the native path runs both front kernels (gate_front's y
        build) and not gate_scan; with ``once``, each front kernel exactly
        once.  Returns the decode and the counts it read."""
        kernels.reset_launches()
        run_o = decode_capture_planar(x2, c)
        torch.cuda.synchronize()
        got = launch_counts()
        log(f"[{label}] launches {got}")
        check(got["gate_front"] and got["gate_stack"] and not got["gate_scan"],
              f"{label}: gate_front and gate_stack must run, gate_scan not")
        check(got["gate_pulses"] == got["gate_stack"],
              f"{label}: one gate_pulses launch a native gate")
        check(got["front_y"] == got["gate_front"] and not got["front_full"],
              f"{label}: gate_front must run its y build only")
        check(not once or (got["gate_front"], got["gate_stack"], got["gate_pulses"]) == (1, 1, 1),
              f"{label}: gate_front, gate_stack and gate_pulses must launch once each")
        return run_o, got

    for label, c, want in (
            ("epc_softfix=8", ReaderConfig(epc_softfix=8), GOLDEN),
            ("track_channel", ReaderConfig(track_channel=True), GOLDEN),
            ("cancel_cw=1", ReaderConfig(cancel_cw=1), GOLDEN),
            # The second strongest line is the tag's own: the JAX package
            # loses every EPC here too (tests/test_torch_fm0_stages.py).
            ("cancel_cw=2", ReaderConfig(cancel_cw=2), (71, 72, 0, 0, 0))):
        run_o, _ = native_path_run(f"golden {label}", x2_gd, c)
        check(golden_tuple(run_o[0]) == want,
              f"golden with {label}: {golden_tuple(run_o[0])}, expected {want}")
        same_as_cpu(f"golden {label}", run_o, decode_capture_planar(x2_g, c, device="cpu"))
        opt_ms = cuda_ms(lambda: decode_capture_planar(x2_gd, c), 5)
        log(f"[golden {label}] tuple {golden_tuple(run_o[0])}, decode {opt_ms:.3f} ms")
    cfg_bo = ReaderConfig(max_events=1536, epc_softfix=8, track_channel=True, cancel_cw=1)
    (st_bo, _), _ = native_path_run("bench softfix+tracking+cancel_cw=1", x2_b, cfg_bo)
    check(int(st_bo.n_epc_correct) == 640 and int(st_bo.tag_reads[27]) == 640,
          f"bench decode with every FM0 switch: {int(st_bo.n_epc_correct)} EPCs")
    opt_bench_ms = cuda_ms(lambda: decode_capture_planar(x2_b, cfg_bo), 5)
    log(f"[bench softfix+tracking+cancel_cw=1] decode {opt_bench_ms:.3f} ms for "
        f"{n_b} samples ({n_b / opt_bench_ms / 1e3:.1f} Msamples/s), 640 / 640 EPCs")
    device_profile(lambda: decode_capture_planar(x2_b, cfg_bo), top=6,
                   label="profile switches")

    # ---- phase 9: the gate-sums tool, then the probe's times ----
    kernels.reset_launches()
    tool = gate_sums_experiment.run(reps=10, log=lambda *a: log("[gate_sums]", *a))
    torch.cuda.synchronize()
    tool_launches = dict(kernels.launches)
    log(f"[gate_sums] launches {tool_launches}")
    check(tool["probe ok"], "the gate-sums tool's probe failed")
    check(tool["blocked == dyadic"], "the gate-sums tool's blocked scan != doubling scan")
    check(tool_launches["probe"] > 0, "the gate-sums tool did not launch the probe")
    for w in gate_sums_experiment.WINS:
        check(tool[f"err_win{w}"] <= 1e-5 * w,
              f"conv sums off the dyadic sums by {tool[f'err_win{w}']} at W={w} (TF32?)")
    x_tile = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32)).to(dev)
    one = torch.ones((), device=dev)
    probe_t = both(lambda: probe(x_tile), 50)
    probe_plain_t = both(lambda: probe_plain(x_tile), 50)
    probe_library_t = both(lambda: torch.add(one, x_tile, alpha=2.0), 50)
    empty_t = both(lambda: torch.cuda._sleep(0), 50)
    probe_bound, probe_by = bound(2 * 4 * x_tile.numel(), 2 * x_tile.numel())
    log(f"[time] probe (8, 128) kernel {fmt(probe_t)}, plain {fmt(probe_plain_t)}, "
        f"torch.add(1, x, alpha=2) {fmt(probe_library_t)}, empty launch "
        f"{fmt(empty_t)}, bound {probe_bound:.2e} ms ({probe_by})")

    hold_kept("phases 5-9")

    # ---- phases 10-12: Miller, wideband, stream ----
    miller_shapes = phase_miller(dev, both, fmt, flush, native_path_run)
    hold_kept("phase 10")
    phase_wideband(dev, both, fmt)
    hold_kept("phase 11")
    stream_tiles = phase_stream(cfg_g, tr_g, st_g, iq_b, cfg_b, flush)
    hold_kept("phase 12")

    # ---- phases 13-14: antenna-diversity MRC, EPC-window SIC ----
    mrc_launches, _ = phase_mrc(dev)
    hold_kept("phase 13")
    sic_launches, _ = phase_sic(dev, x2_b, cfg_b)
    hold_kept("phase 14")

    # ---- phase 15: the CLI on the card ----
    cli_launches_b, cli_launches_exact = phase_cli(dev, iq_b, tr_g)
    hold_kept("phase 15")

    # ---- phase 16: 8 and 16 Msps captures, the segment kernel's widest ----
    high, high_launches = phase_high_rates(dev, both, fmt, flush, native_path_run)
    hold_kept("phase 16")
    # ---- phase 16b: compat and the exact gate at every native geometry ----
    modes_rows, modes_launches, modes_sweep = phase_geometry_modes(dev, both, fmt, flush)
    hold_kept("phase 16b")
    # ---- phase 17: the closed-loop live reader ----
    live = phase_live(dev, both, fmt, flush)
    hold_kept("phase 17")
    # ---- phase 18: the time- and channel-sharded decode ----
    sharded_launches, shard_rows = phase_sharded(dev, iq_b, both, fmt)
    hold_kept("phase 18")
    kernels.keep_inputs(False)
    # ---- phase 19: the envelope sweeps ----
    sweep_launches = phase_sweeps(dev)
    # ---- phase 20: the bench twins at full size ----
    bench_launches, bench_y_rows = phase_bench(dev, both, fmt)
    segment_rows.update({k: miller_shapes["gate_stack"][k] for k in miller_shapes["gate_stack"]})
    segment_rows.update(high["segment"])
    seg_main = segment_rows["miller4"]
    y_rows.update(miller_shapes["gate_front_y"])
    y_rows.update(high["y"])
    y_rows.update(bench_y_rows)
    y_rows["bench_shard"] = shard_rows["gate_front_y"]
    y_main = y_rows["bench"]

    # ms, plain_ms and library_ms are written-flush times (the earlier
    # yardstick); the *_read keys the read-flush ones (L2 clean before each
    # run).  gate_scan's plain version is a host loop timed once, unflushed.
    # gate_front's two builds: the full one (compat mode and the exact gate;
    # its launches are the compat bench decode's) and the y build (every
    # path that reads only y; its launches are the native bench decode's).
    kernel_line = {"kernels": [
        {"name": "gate_front", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_front.cu",
         "replaces": "gen2_rfid_tpu/kernels/gate_front.py:88",
         "launches": compat_launches["front_full"], "max_abs_err": err_front,
         "ms": front_t["write"], "plain_ms": front_plain_t["write"], "bound_ms": front_b,
         "bound_by": front_by, "library_ms": None, "ms_read": front_t["read"],
         "plain_ms_read": front_plain_t["read"], "library_ms_read": None,
         "launches_exact": exact_launches["front_full"],
         "launches_cli_exact": cli_launches_exact["front_full"],
         "miller": miller_shapes["gate_front"], "high_rates": high["full"],
         "geometry_modes": modes_rows["gate_front"],
         "launches_geometry_modes": modes_launches["gate_front"],
         "live_shapes": live["gate_front"][1], "sharded_shape": shard_rows["gate_front"]},
        {"name": "gate_front_y", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_front.cu",
         "replaces": "gen2_rfid_tpu/kernels/gate_front.py:88",
         "launches": main_launches["front_y"], "max_abs_err": err_y,
         "ms": y_main["ms"], "plain_ms": y_main["plain_ms"], "bound_ms": y_main["bound_ms"],
         "bound_by": y_main["bound_by"], "library_ms": y_main["library_ms"],
         "ms_read": y_main["ms_read"], "plain_ms_read": y_main["plain_ms_read"],
         "library_ms_read": y_main["library_ms_read"], "shapes": y_rows,
         "launches_mrc4": mrc_launches["front_y"],
         "launches_sic2_recovery": sic_launches["front_y"],
         "launches_cli": cli_launches_b["front_y"],
         "launches_live": live["gate_front_y"][0], "live_shapes": live["gate_front_y"][1],
         "stream_tiles": stream_tiles,
         "launches_sharded": sharded_launches["front_y"],
         "launches_sweeps": sweep_launches["front_y"],
         "launches_bench": bench_launches["front_y"]},
        {"name": "gate_stack", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_stack.cu",
         "replaces": "gen2_rfid_tpu/kernels/gate_stack.py:113",
         "launches": main_launches["gate_stack"], "max_abs_err": err_stack,
         "ms": stack_t["write"], "plain_ms": stack_plain_t["write"], "bound_ms": stack_b,
         "bound_by": stack_by, "library_ms": None, "ms_read": stack_t["read"],
         "plain_ms_read": stack_plain_t["read"], "library_ms_read": None,
         "launches_cli": cli_launches_b["gate_stack"],
         "launches_live": live["gate_stack"][0], "live_shapes": live["gate_stack"][1],
         "launches_sharded": sharded_launches["gate_stack"],
         "sharded_shape": shard_rows["gate_stack"],
         "launches_sweeps": sweep_launches["stream"],
         "launches_bench": bench_launches["stream"]},
        # The segment kernel: gate_stack at every width but ReaderConfig's.
        # Its top-level times are miller4's; "shapes" holds each timed
        # shape; "launches" counts the phase 16 decodes', each shape's row
        # its own decode's.
        {"name": "gate_stack_segment", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_stack.cu",
         "replaces": "gen2_rfid_tpu/kernels/gate_stack.py:113",
         "launches": high_launches,
         "max_abs_err": max(r["max_abs_err"] for r in segment_rows.values()),
         "ms": seg_main["ms"], "plain_ms": seg_main["plain_ms"], "bound_ms": seg_main["bound_ms"],
         "bound_by": seg_main["bound_by"], "library_ms": None, "ms_read": seg_main["ms_read"],
         "plain_ms_read": seg_main["plain_ms_read"], "library_ms_read": None,
         "shapes": segment_rows, "launches_sweeps": sweep_launches["segment"],
         "launches_bench": bench_launches["segment"]},
        {"name": "gate_scan", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_scan.cu",
         "replaces": "gen2_rfid_tpu/dsp/gate.py:366",
         "launches": exact_launches["gate_scan"], "max_abs_err": err_scan,
         "ms": scan_t["write"], "plain_ms": scan_plain_ms, "bound_ms": scan_bound,
         "bound_by": scan_by, "library_ms": None, "ms_read": scan_t["read"],
         "plain_ms_read": None, "library_ms_read": None,
         "launches_cli": cli_launches_exact["gate_scan"], "shapes": modes_rows["gate_scan"],
         "launches_geometry_modes": modes_launches["gate_scan"]},
        # compat_gate: its launches are the compat bench decode's; its
        # stream, shard and live launches beside them; its design, device
        # kernels a call and tile at bench; its rows at bench, golden, a live
        # window and fm0_16msps, and its configurations swept there; the
        # compat bench decode with the plain chain and with the kernel (ms in
        # turns; device busy ms and ops).
        {"name": "compat_gate", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/compat_gate.cu",
         "replaces": "gen2_rfid_tpu/dsp/gate.py:92,208,245,256",
         "launches": compat["launches"]["compat_gate"], "max_abs_err": compat["err"],
         "ms": compat["rows"]["bench"]["ms"], "plain_ms": compat["rows"]["bench"]["plain_ms"],
         "bound_ms": compat["rows"]["bench"]["bound_ms"],
         "bound_by": compat["rows"]["bench"]["bound_by"],
         "library_ms": compat["rows"]["bench"]["library_ms"],
         "ms_read": compat["rows"]["bench"]["ms_read"],
         "plain_ms_read": compat["rows"]["bench"]["plain_ms_read"],
         "library_ms_read": compat["rows"]["bench"]["library_ms_read"],
         "design": "one launch: a single-pass scan of 20-word carry descriptors with "
                   "decoupled look-back (ticketed tiles, epoch-tagged statuses, the launch "
                   "state kept in its scratch, a halo of nt1 + 1 samples)",
         "kernels_a_call": compat["rows"]["bench"]["kernels_a_call"],
         "tile": compat["rows"]["bench"]["tile"], "config": compat["rows"]["bench"]["config"],
         "sweep": {**compat["sweep"], **modes_sweep},
         "shapes": {**compat["rows"], **modes_rows["compat_gate"]},
         "launches_geometry_modes": modes_launches["compat_gate"],
         "launches_stream": compat["stream"],
         "launches_sharded": compat["sharded"], "launches_live": compat["live"],
         "compat_decode_ms": compat["decode_ms"], "compat_decode_profile": compat["profile"]},
        # gate_pulses: its launches are the native bench decode's; its rows
        # at bench and at the benchmark cell's Ny; bit-equal to its plain
        # version there and at every kept input (hold_kept).
        {"name": "gate_pulses", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/gate_pulses.cu",
         "replaces": "gen2_rfid_tpu/dsp/gate.py:108",
         "launches": main_launches["gate_pulses"], "max_abs_err": 0,
         "ms": pulse_rows["bench"]["ms"], "plain_ms": pulse_rows["bench"]["plain_ms"],
         "bound_ms": pulse_rows["bench"]["bound_ms"],
         "bound_by": pulse_rows["bench"]["bound_by"], "library_ms": None,
         "ms_read": pulse_rows["bench"]["ms_read"],
         "plain_ms_read": pulse_rows["bench"]["plain_ms_read"], "library_ms_read": None,
         "shapes": pulse_rows, "launches_cli": cli_launches_b["gate_pulses"],
         "launches_mrc4": mrc_launches["gate_pulses"],
         "launches_exact": exact_launches["gate_pulses"],
         "launches_compat": compat_launches["gate_pulses"],
         "launches_sharded": sharded_launches["gate_pulses"],
         "launches_sweeps": sweep_launches["gate_pulses"],
         "launches_bench": bench_launches["gate_pulses"]},
        {"name": "probe", "route": "cuda",
         "source": "gen2_rfid_tpu_torch/csrc/probe.cu",
         "replaces": "tools/tpu_gate_sums_experiment.py:116",
         "launches": tool_launches["probe"], "max_abs_err": err_probe,
         "ms": probe_t["write"], "plain_ms": probe_plain_t["write"], "bound_ms": probe_bound,
         "bound_by": probe_by, "library_ms": probe_library_t["write"],
         "ms_read": probe_t["read"], "plain_ms_read": probe_plain_t["read"],
         "library_ms_read": probe_library_t["read"]},
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
