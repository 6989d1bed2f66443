"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built at first
use) and skip without one.  The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX).
"""

import numpy as np
import pytest
import torch

from gen2_rfid_tpu_torch import kernels
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.kernels.compat_gate import (
    CONFIGS, TILE, compat_cases, compat_gate, compat_gate_for_cfg, compat_gate_plain,
    config_tile)
from gen2_rfid_tpu_torch.kernels.gate_front import (
    BLOCK_Y, BLOCK_Y_Y, gate_front, gate_front_plain, gate_front_y, gate_front_y_plain)
from gen2_rfid_tpu_torch.kernels.gate_pulses import (
    gate_pulses, kernel_geometry, pulse_cases, random_flags, tile_geometry)
from gen2_rfid_tpu_torch.kernels.gate_scan import (
    dense_edges, gate_scan, gate_scan_for_cfg, gate_scan_plain, pulse_train, random_runs)
from gen2_rfid_tpu_torch.kernels.gate_stack import (
    SEGMENT_GEOS, burst_capture, check_arith, gate_stack_flags, gate_stack_plain,
    gate_stack_shape, segment_cases, segment_smem_bytes, stream_geometry)
from gen2_rfid_tpu_torch.kernels.gate_stack import stream_cases as gate_stack_cases
from gen2_rfid_tpu_torch.kernels.probe import probe, probe_plain
from gen2_rfid_tpu_torch.tools.sweep import rows, run_twin, table_diff

CFG = ReaderConfig()
STACK_ARGS = (CFG.win_length, CFG.n_samples_pw // 2, CFG.n_samples_t1,
              CFG.thresh_fraction)

CFG_COMPAT = ReaderConfig(mode="compat")
CFG_COMPAT_ARGS = (CFG_COMPAT.thresh_fraction, CFG_COMPAT.n_samples_pw // 2,
                   CFG_COMPAT.n_samples_t1, CFG_COMPAT.num_pulses_command)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card; the tests skip on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _noise(n, seed):
    return np.random.default_rng(seed).normal(size=(2, n)).astype(np.float32)


@pytest.mark.parametrize("n,block_y", [(40961, 512), (9999, 64), (10240, 2048), (7, 512)])
def test_gate_front_kernel_matches_plain(cuda, n, block_y):
    x2 = torch.from_numpy(_noise(n, n)).to(cuda)
    before = kernels.launches["gate_front"]
    got = gate_front(x2, 5, 25, 100, 48, block_y=block_y)
    want = gate_front_plain(x2, 5, 25, 100, 48)
    torch.cuda.synchronize()
    assert kernels.launches["gate_front"] == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# N giving ny % 4 = 1..3 (the thread's 4 outputs), ny < 4 and ny < the
# 99-sample halo.
FRONT_LENGTHS = [5 * (16000 + m) + m % 5 for m in range(1, 4)] + [5 * 3 + 2, 5 * 50 + 4]


@pytest.mark.parametrize("block_y", [BLOCK_Y, 512, 1024, 64])
def test_gate_front_kernel_bit_equal_at_remainders(cuda, block_y):
    """Every ragged end of the register blocking, bit for bit."""
    for n in FRONT_LENGTHS:
        x2 = torch.from_numpy(_noise(n, n)).to(cuda)
        got = gate_front(x2, 5, 25, 100, 48, block_y=block_y)
        want = gate_front_plain(x2, 5, 25, 100, 48)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (n, block_y)


@pytest.mark.parametrize("decim,taps,win,dcw", [(3, 7, 10, 13), (2, 9, 5, 3), (1, 1, 1, 1),
                                                (5, 25, 100, 47)])
def test_gate_front_kernel_other_shapes(cuda, decim, taps, win, dcw):
    """Other decimations, taps and windows than ReaderConfig's (the kernel
    compiled with runtime loop bounds), bit for bit."""
    x2 = torch.from_numpy(_noise(30001, decim)).to(cuda)
    got = gate_front(x2, decim, taps, win, dcw, block_y=256)
    want = gate_front_plain(x2, decim, taps, win, dcw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gate_front_kernel_on_unaligned_input(cuda):
    """x2 starting 4 bytes past a 16-byte boundary, with an odd N."""
    n = 40963
    flat = torch.empty(2 * n + 1, device=cuda)[1:]
    x2 = flat.view(2, n).copy_(torch.from_numpy(_noise(n, 5)))
    assert x2.data_ptr() % 16 == 4
    got = gate_front(x2, 5, 25, 100, 48)
    want = gate_front_plain(x2, 5, 25, 100, 48)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gate_front_kernel_rejects_bad_blocking(cuda):
    x2 = torch.zeros((2, 1000), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        gate_front(x2, 5, 25, 100, 48, block_y=514)
    with pytest.raises(ValueError, match="too large"):
        gate_front(x2, 5, 25, 100, 48, block_y=4096)


# ---- gate_front's y build ------------------------------------------------------

def _same_y(x2, decim, taps, block_y=None, win=100, dcw=48):
    """The y build against its plain version and the full build's y."""
    got = gate_front_y(x2, decim, taps, block_y=block_y)
    want = gate_front_y_plain(x2, decim, taps)
    full = gate_front(x2, decim, taps, win, dcw)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, full), (decim, taps, block_y)


@pytest.mark.parametrize("n,block_y", [(40961, 512), (9999, 64), (10240, 2048), (7, 512)])
def test_gate_front_y_kernel_matches_plain(cuda, n, block_y):
    x2 = torch.from_numpy(_noise(n, n)).to(cuda)
    before = dict(kernels.launches), dict(kernels.front_bodies)
    got = gate_front_y(x2, 5, 25, block_y=block_y)
    torch.cuda.synchronize()
    assert kernels.launches["gate_front"] == before[0]["gate_front"] + 1
    assert kernels.front_bodies == {"full": before[1]["full"], "y": before[1]["y"] + 1}
    assert torch.equal(got, gate_front_y_plain(x2, 5, 25))


# N giving ny % 8 = 1..7 (the thread's 8 outputs) and ny < 8.
Y_LENGTHS = [5 * (16000 + m) + m % 5 for m in range(1, 8)] + [5 * 3 + 2, 5 * 7 + 4]


@pytest.mark.parametrize("block_y", [BLOCK_Y_Y, 512, 1024, 64, 8])
def test_gate_front_y_kernel_bit_equal_at_remainders(cuda, block_y):
    """Every ragged end of the register blocking, bit for bit."""
    for n in Y_LENGTHS:
        _same_y(torch.from_numpy(_noise(n, n)).to(cuda), 5, 25, block_y)


@pytest.mark.parametrize("decim,taps", [(1, 6), (2, 12), (2, 6), (1, 100), (1, 200), (3, 7),
                                        (2, 9), (1, 1), (5, 24)])
def test_gate_front_y_kernel_other_shapes(cuda, decim, taps):
    """Other decimations and filter lengths than ReaderConfig's (the walk
    with runtime bounds: the Miller, blf640 and 8 / 16 Msps widths among
    them), bit for bit, at short and long inputs."""
    for n, block_y in ((30001, None), (30001, 256), (taps + 2, None)):
        _same_y(torch.from_numpy(_noise(n, decim)).to(cuda), decim, taps, block_y)


def test_gate_front_y_kernel_on_unaligned_input(cuda):
    """x2 starting 4 bytes past a 16-byte boundary, with an odd N."""
    n = 40963
    flat = torch.empty(2 * n + 1, device=cuda)[1:]
    x2 = flat.view(2, n).copy_(torch.from_numpy(_noise(n, 5)))
    assert x2.data_ptr() % 16 == 4
    _same_y(x2, 5, 25)
    _same_y(x2, 1, 200)


def test_gate_front_y_kernel_rejects_bad_blocking(cuda):
    x2 = torch.zeros((2, 1000), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        gate_front_y(x2, 5, 25, block_y=516)
    with pytest.raises(ValueError, match="too large"):
        gate_front_y(x2, 5, 25, block_y=40000)


@pytest.mark.parametrize("adc", [8e6, 16e6])
def test_gate_front_y_kernel_at_high_rates(cuda, adc):
    """At 8 and 16 Msps, decim 1 (T 100 and 200): the walk's unpredicated
    middle carries most of the adds."""
    from gen2_rfid_tpu_torch.kernels.gate_front import front_taps

    c = ReaderConfig(adc_rate=adc, decim=1)
    _same_y(torch.from_numpy(_noise(300_007, 13)).to(cuda), 1, front_taps(c),
            win=c.win_length, dcw=c.dc_length)


def test_gate_front_y_tile_spreads_short_captures(cuda):
    """A short capture's tile gives every SM a tile; a long one takes
    BLOCK_Y_Y."""
    from gen2_rfid_tpu_torch.kernels.gate_front import y_block_y

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert y_block_y(5, 25, 921, cuda) == 8
    assert y_block_y(5, 25, 8 * sms * 3 - 1, cuda) == 24
    assert y_block_y(5, 25, 10 ** 7, cuda) == BLOCK_Y_Y == 1024


def test_front_bodies_count_each_build_and_keep_it(cuda):
    """gate_front counts each launch under its build and keeps the build in
    its input's geometry."""
    kernels.reset_launches()
    kernels.keep_inputs(True)
    try:
        x2 = torch.from_numpy(_noise(1000, 4)).to(cuda)
        gate_front_y(x2, 5, 25)
        gate_front_y(x2, 5, 25)
        gate_front(x2, 5, 25, 100, 48)
    finally:
        kernels.keep_inputs(False)
    torch.cuda.synchronize()
    assert kernels.launches["gate_front"] == 3 and kernels.front_bodies == {"full": 1, "y": 2}
    assert sorted(k[2] for k in kernels.kept) == ["full", "y"]


@pytest.mark.parametrize("n,run", [(40961, 32), (9999, 8), (10240, 128), (150, 0)])
def test_gate_stack_kernel_matches_plain(cuda, n, run):
    y2 = torch.from_numpy(_noise(n, n)).to(cuda)
    before = kernels.launches["gate_stack"]
    got = gate_stack_flags(y2, *STACK_ARGS, run=run)
    want = gate_stack_plain(y2, *STACK_ARGS)
    torch.cuda.synchronize()
    assert kernels.launches["gate_stack"] == before + 1
    assert torch.equal(got, want)


def test_kernels_count_bodies_and_keep_inputs(cuda):
    """gate_stack counts each launch under the body that ran; while keeping,
    gate_front and gate_stack keep one copy of their input a shape and
    geometry, and nothing once stopped."""
    kernels.reset_launches()
    kernels.keep_inputs(True)
    try:
        y2 = torch.from_numpy(_noise(5000, 3)).to(cuda)
        for _ in range(2):
            gate_stack_flags(y2, *STACK_ARGS)
        gate_stack_flags(y2, *SEGMENT_GEOS["miller2"])
        gate_front(torch.from_numpy(_noise(1000, 4)).to(cuda), 5, 25, 100, 48)
    finally:
        kernels.keep_inputs(False)
    gate_front(torch.from_numpy(_noise(2000, 5)).to(cuda), 5, 25, 100, 48)
    torch.cuda.synchronize()
    assert kernels.stack_bodies == {"stream": 2, "segment": 1}
    assert kernels.launches["gate_stack"] == 3 and kernels.launches["gate_front"] == 2
    assert sorted((k[0], k[1]) for k in kernels.kept) == [
        ("gate_front", (2, 1000)), ("gate_stack", (2, 5000)), ("gate_stack", (2, 5000))]
    for key, x in kernels.kept.items():
        assert x.device.type == "cuda" and (key[0] != "gate_stack" or torch.equal(x, y2))


def test_gate_stack_arithmetic_is_ieee(cuda):
    """The stream kernel's branch-free root and division by 100 equal the
    IEEE intrinsics on every float of their range, 0 and [2^-100, FLT_MAX]
    (a warp that meets any other input recomputes with the intrinsics)."""
    got = check_arith()
    assert got["sqrt_differs"] == 0 and got["div_differs"] == 0, got


def test_gate_stack_kernel_on_the_model_cases(cuda):
    """Every input the CPU models are held to (edge lengths, run and
    segment boundaries, ties, all above or below, tiny and infinite
    samples): the warp stream's at ReaderConfig's widths, and the segment
    kernel's at the Miller, blf640, 160 kHz, Tari 6.25 us, Miller-8 320 kHz
    and 8 and 16 Msps FM0 widths."""
    for label, y2, geo, run in gate_stack_cases() + segment_cases():
        got = gate_stack_flags(y2.to(cuda), *geo, run=run)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), gate_stack_plain(y2, *geo)), label


def test_gate_stack_segment_kernel_shape(cuda):
    """The segment kernel's shared memory is the Python mirror's, at least
    one block fits an SM, and the automatic segment makes one wave."""
    for label, geo in SEGMENT_GEOS.items():
        shp = gate_stack_shape(4_000_000, *geo[:3])
        assert shp["smem_bytes"] == segment_smem_bytes(*geo[:3]), label
        assert shp["blocks_per_sm"] >= 1 and shp["threads"] == 256, label
        assert shp["grid"] <= shp["blocks_per_sm"] * shp["sms"], label
        assert gate_stack_shape(4_000_000, *geo[:3], run=100)["run"] == 100, label


def test_gate_stack_raises_on_widths_the_kernels_cannot_take(cuda):
    y2 = torch.zeros((2, 1000), device=cuda)
    with pytest.raises(ValueError, match="levels"):
        gate_stack_flags(y2, 8192, 2, 96, 0.75)
    with pytest.raises(ValueError, match="shared memory"):
        gate_stack_flags(y2, 100, 2, 1_000_000, 0.75)


def _auto_run(ny, sms):
    """The stream kernel's automatic run (csrc/gate_stack.cu::stream_run):
    16 warps an SM, within [5, 253] words, rounded up so that a warp's steps
    are a whole number of 4-step groups."""
    left, delay, _, _ = stream_geometry(*STACK_ARGS[:3])
    nwords = -(-ny // 32)
    run = min(max(-(-nwords // (16 * sms)), 5), 253)
    return -(-(left + delay + run) // 4) * 4 - left - delay


@pytest.mark.parametrize("past", [0, 1, None])
def test_gate_stack_kernel_at_bench_lengths(cuda, past):
    """Bench-size bursts whose length lands on a run boundary of the
    automatic run at the bench Ny (``past`` 0), one sample past it (1), and
    the bench Ny itself (None)."""
    bench_ny = 1_940_860
    shp = gate_stack_shape(bench_ny, *STACK_ARGS[:3])
    run = shp["run"]
    assert run == _auto_run(bench_ny, shp["sms"])
    ny = bench_ny if past is None else 32 * run * 2000 + past
    y2 = burst_capture(ny, 3).to(cuda)
    want = gate_stack_plain(y2, *STACK_ARGS)
    for r in (0, run, 64):
        assert torch.equal(gate_stack_flags(y2, *STACK_ARGS, run=r), want), r


def _amp_avg(n, seed):
    """|y| of noise around a CW level and its 100-sample average."""
    y2 = torch.from_numpy(_noise(n, seed) * 0.3 + np.array([[1.0], [0.5]], np.float32))
    amp = torch.sqrt(y2[0] ** 2 + y2[1] ** 2)
    avg = torch.nn.functional.avg_pool1d(
        torch.nn.functional.pad(amp[None, None], (99, 0)), 100, 1)[0, 0]
    return amp, avg


@pytest.mark.parametrize("n", [40961, 9999, 4096, 4097, 1])
def test_gate_scan_kernel_matches_plain(cuda, n):
    amp, avg = _amp_avg(n, n)
    # Ties: a stretch where amp equals its threshold exactly.
    avg[: min(n, 50)] = amp[: min(n, 50)] / CFG.thresh_fraction
    before = kernels.launches["gate_scan"]
    trig, pulses = gate_scan_for_cfg(amp.to(cuda), avg.to(cuda), CFG)
    torch.cuda.synchronize()
    assert kernels.launches["gate_scan"] == before + 1
    want_trig, want_pulses = gate_scan_for_cfg(amp, avg, CFG)
    assert torch.equal(trig.cpu(), want_trig)
    assert torch.equal(pulses.cpu(), want_pulses)


@pytest.mark.parametrize("n,rn16w,epcw", [(40961, 1, 1), (40961, 1, 37), (20481, 40, 4100),
                                          (12289, 33, 64), (4097, 5, 3), (4096, 1, 1)])
def test_gate_scan_kernel_on_pulse_trains(cuda, n, rn16w, epcw):
    """Triggers on word and chunk ends and on the last sample, open windows
    across chunk edges, windows of one sample, and ties."""
    args = (0.5, 2, 5, 3, rn16w, epcw)
    amp, avg, targets = pulse_train(n, 2, 5, 3, rn16w, epcw, seed=n)
    before = kernels.launches["gate_scan"]
    trig, pulses = gate_scan(amp.to(cuda), avg.to(cuda), *args)
    torch.cuda.synchronize()
    assert kernels.launches["gate_scan"] == before + 1
    want_trig, want_pulses = gate_scan_plain(amp, avg, *args)
    assert trig.cpu().nonzero().flatten().tolist() == targets
    assert torch.equal(trig.cpu(), want_trig)
    assert torch.equal(pulses.cpu(), want_pulses)


@pytest.mark.parametrize("n", [1_940_860, 100_003, 1025, 33, 1])
def test_gate_scan_kernel_on_dense_edges(cuda, n):
    """An edge about every other sample (the walk's worst case), at the bench
    length and at lengths that are not multiples of 32 or 1024; the second
    set of arguments triggers often."""
    amp, avg = dense_edges(n, seed=n)
    for args in ((CFG.thresh_fraction, 2, 96, 5, 250, 1384), (0.75, 0, 0, 0, 1, 3)):
        trig, pulses = gate_scan(amp.to(cuda), avg.to(cuda), *args)
        want_trig, want_pulses = gate_scan_plain(amp, avg, *args)
        assert torch.equal(trig.cpu(), want_trig), args
        assert torch.equal(pulses.cpu(), want_pulses), args


def test_gate_scan_kernel_on_random_runs(cuda):
    """Frequent triggers, resuming after windows that end in every state."""
    for seed in range(40):
        amp, avg, args = random_runs(seed)
        trig, pulses = gate_scan(amp.to(cuda), avg.to(cuda), *args)
        want_trig, want_pulses = gate_scan_plain(amp, avg, *args)
        assert torch.equal(trig.cpu(), want_trig), seed
        assert torch.equal(pulses.cpu(), want_pulses), seed


@pytest.mark.parametrize("n", [5000, 1])
def test_gate_scan_kernel_on_ties(cuda, n):
    """amp equal to its threshold everywhere: no edge, no trigger."""
    amp = torch.ones(n)
    trig, pulses = gate_scan_for_cfg(amp.to(cuda), (amp / CFG.thresh_fraction).to(cuda), CFG)
    want_trig, want_pulses = gate_scan_for_cfg(amp, amp / CFG.thresh_fraction, CFG)
    assert torch.equal(trig.cpu(), want_trig) and not bool(want_trig.any())
    assert torch.equal(pulses.cpu(), want_pulses)


def test_gate_scan_kernel_on_golden(cuda):
    """142 triggers, open windows across chunk boundaries."""
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
    from gen2_rfid_tpu_torch.runtime.inventory import to_planar
    from gen2_rfid_tpu_torch.sim.trace import golden_trace

    _, amp, avgsum, _ = gate_front_for_cfg(to_planar(golden_trace(CFG).iq), CFG)
    avg = avgsum / torch.tensor(float(CFG.win_length))
    trig, pulses = gate_scan_for_cfg(amp.to(cuda), avg.to(cuda), CFG)
    want_trig, want_pulses = gate_scan_for_cfg(amp, avg, CFG)
    assert int(want_trig.sum()) == 142
    assert torch.equal(trig.cpu(), want_trig)
    assert torch.equal(pulses.cpu(), want_pulses)


@pytest.mark.parametrize("tile", [32, 33, TILE])
def test_compat_gate_kernel_on_the_cases(cuda, tile):
    """Every input of compat_cases (ties across tiles, edges and trig0 on a
    tile's first and last sample, the fixed point's shift across a tile
    edge, the tail, lengths around a tile): one launch each, equal to the
    plain version."""
    for label, amp, avg, args in compat_cases(tile):
        before = kernels.launches["compat_gate"]
        trig, pulses = compat_gate(amp.to(cuda), avg.to(cuda), *args)
        torch.cuda.synchronize()
        assert kernels.launches["compat_gate"] == before + 1, label
        want_trig, want_pulses = compat_gate_plain(amp, avg, *args)
        assert trig.dtype == torch.bool and pulses.dtype == torch.int32
        assert torch.equal(trig.cpu(), want_trig), label
        assert torch.equal(pulses.cpu(), want_pulses), label


@pytest.mark.parametrize("n", [9_000_001, 4_194_305, 1_940_860, 100_003, 4097, 4096, 33, 1])
def test_compat_gate_kernel_on_drawn_decisions(cuda, n):
    """Above, below and tied samples drawn at random, at the bench length,
    past 1,024 tiles (look-back windows of 256 predecessors, several
    rounds) and around a tile, with small widths (frequent short rises and
    triggers)."""
    amp = torch.from_numpy(np.random.default_rng(n).choice([0.0, 0.5, 1.0], n)
                           .astype(np.float32))
    avg = torch.ones(n)
    for args in ((0.5, 2, 5, 3), (0.5, 0, 0, 0), CFG_COMPAT_ARGS):
        trig, pulses = compat_gate(amp.to(cuda), avg.to(cuda), *args)
        want_trig, want_pulses = compat_gate_plain(amp, avg, *args)
        assert torch.equal(trig.cpu(), want_trig), args
        assert torch.equal(pulses.cpu(), want_pulses), args


@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_compat_gate_every_config(cuda, config):
    """Each configuration of the kernel on every input of compat_cases at
    its own tile, on drawn decisions past 1,024 of its tiles and around a
    tile, and at the 16 Msps widths (nt1 3,840)."""
    tile = config_tile(config)
    inputs = [(label, amp, avg, args) for label, amp, avg, args in compat_cases(tile)]
    for n in (1024 * tile + 5, 3 * tile + 1, tile, 77):
        amp = torch.from_numpy(np.random.default_rng(n).choice([0.0, 0.5, 1.0], n)
                               .astype(np.float32))
        inputs += [(f"drawn n={n} {args}", amp, torch.ones(n), args)
                   for args in ((0.5, 2, 5, 3), (0.5, 96, 3840, 5))]
    for label, amp, avg, args in inputs:
        a, v = amp.to(cuda), avg.to(cuda)
        trig, pulses = compat_gate(a, v, *args, config=config)
        want_trig, want_pulses = compat_gate_plain(a, v, *args)
        assert torch.equal(trig, want_trig), label
        assert torch.equal(pulses, want_pulses), label


@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_compat_gate_kernel_repeats_bit_for_bit(cuda, config):
    """200 launches on one drawn input of the bench length give the same bits
    each time (a look-back that read a carry too early would not)."""
    n = 1_940_860
    amp = torch.from_numpy(np.random.default_rng(5).choice([0.0, 0.5, 1.0], n, p=[0.3, 0.1, 0.6])
                           .astype(np.float32)).to(cuda)
    avg = torch.ones(n, device=cuda)
    want_trig, want_pulses = compat_gate_plain(amp, avg, 0.5, 2, 5, 3)
    bad = 0
    for _ in range(200):
        trig, pulses = compat_gate(amp, avg, 0.5, 2, 5, 3, config=config)
        bad += int((trig != want_trig).sum()) + int((pulses != want_pulses).sum())
    assert bad == 0


def _drawn_decisions(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).choice([0.0, 0.5, 1.0], n)
                            .astype(np.float32))


def test_compat_gate_graph_replays(cuda):
    """A launch captured in a CUDA graph and replayed on new inputs gives the
    plain version's bits each time (the kernel keeps its per-launch state in
    its scratch, so the captured arguments serve every replay)."""
    n = 1_940_860
    stream = torch.cuda.Stream()
    amp, avg = _drawn_decisions(n, 0).to(cuda), torch.ones(n, device=cuda)
    with torch.cuda.stream(stream):
        compat_gate(amp, avg, 0.5, 2, 5, 3)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        trig, pulses = compat_gate(amp, avg, 0.5, 2, 5, 3)
    for seed in range(1, 6):
        amp.copy_(_drawn_decisions(n, seed))
        graph.replay()
        torch.cuda.synchronize()
        want_trig, want_pulses = compat_gate_plain(amp, avg, 0.5, 2, 5, 3)
        assert torch.equal(trig, want_trig) and torch.equal(pulses, want_pulses), seed


def test_compat_gate_epochs_past_32_bits(cuda):
    """Launches whose epochs lie past 2^32 read none of the statuses that a
    launch of epoch 1 left (epochs cut to 32 bits would), and each moves the
    launch word on by one launch."""
    from gen2_rfid_tpu_torch.kernels import compat_gate as cg

    n = 300_001
    stream = torch.cuda.Stream()
    first, second = _drawn_decisions(n, 1).to(cuda), _drawn_decisions(n, 2).to(cuda)
    avg = torch.ones(n, device=cuda)
    with torch.cuda.stream(stream):
        got = [compat_gate(first, avg, 0.5, 2, 5, 3)]          # epoch 1
        word = cg._scratch[(first.device.index, stream.cuda_stream)][0].view(torch.int64)
        word[0] = (1 << 32) << cg.TICKET_BITS                 # then epochs 2^32 + 1, + 2
        got += [compat_gate(second, avg, 0.5, 2, 5, 3) for _ in range(2)]
    stream.synchronize()
    assert int(word[0]) == ((1 << 32) + 2) << cg.TICKET_BITS
    for (trig, pulses), amp in zip(got, (first, second, second)):
        want_trig, want_pulses = compat_gate_plain(amp, avg, 0.5, 2, 5, 3)
        assert torch.equal(trig, want_trig) and torch.equal(pulses, want_pulses)


@pytest.mark.parametrize("n", [100_003, 4000])
def test_compat_gate_kernel_on_unaligned_input(cuda, n):
    """amp and avg 4 bytes past a 16-byte boundary (the loads take any
    alignment), over several tiles and in one, in every configuration."""
    amp = torch.from_numpy(np.random.default_rng(n).choice([0.0, 0.5, 1.0], n)
                           .astype(np.float32))
    buf = torch.empty(2 * n + 2, device=cuda)
    a, v = buf[1:n + 1], buf[n + 2:]
    a.copy_(amp)
    v.fill_(1.0)
    assert a.data_ptr() % 16 and v.data_ptr() % 16
    for config in range(len(CONFIGS)):
        trig, pulses = compat_gate(a, v, 0.5, 2, 5, 3, config=config)
        want_trig, want_pulses = compat_gate_plain(amp, torch.ones(n), 0.5, 2, 5, 3)
        assert torch.equal(trig.cpu(), want_trig) and torch.equal(pulses.cpu(), want_pulses)


def test_compat_gate_kernel_on_golden(cuda):
    """142 triggers; the compat decode on the card goes through one launch of
    gate_front's full build and one of compat_gate, equal to the CPU decode."""
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.sim.trace import golden_trace

    c = ReaderConfig(mode="compat")
    x2 = to_planar(golden_trace(c).iq)
    _, amp, avgsum, _ = gate_front_for_cfg(x2, c)
    avg = avgsum / torch.tensor(float(c.win_length))
    trig, pulses = compat_gate_for_cfg(amp.to(cuda), avg.to(cuda), c)
    want_trig, want_pulses = compat_gate_for_cfg(amp, avg, c)
    assert int(want_trig.sum()) == 142
    assert torch.equal(trig.cpu(), want_trig) and torch.equal(pulses.cpu(), want_pulses)
    before = dict(kernels.launches)
    st, dec = decode_capture_planar(x2.to(cuda), c)
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": 1, "gate_stack": 0, "gate_scan": 0, "compat_gate": 1, "probe": 0,
        "gate_pulses": 0}
    st_c, dec_c = decode_capture_planar(x2, c, device="cpu")
    _same_int_fields(dec, dec_c)
    _same_int_fields(st, st_c)


# ---- the native gate's pulse count -----------------------------------------------

# The native geometries: ReaderConfig(), the Miller-4 benchmark file's reader,
# Miller-4 at decim 1, FM0 at 8 and 16 Msps, and a block under 8 samples.
PULSE_GEOMETRIES = {
    "reader": {},
    "miller4_file": dict(miller_m=4, blf_hz=40e3, dr=1, pw_us=12, delim_us=12, trcal_us=133,
                         rtcal_us=72, decim=1, t1_us=128, t2_us=62),
    "miller4": dict(miller_m=4, decim=1),
    "fm0_8msps": dict(adc_rate=8e6, decim=1),
    "fm0_16msps": dict(adc_rate=16e6, decim=1),
    "block_under_8": dict(t1_us=10),
}


def _pulse_geometry(name):
    from gen2_rfid_tpu_torch.dsp.gate import block_size, pulse_window

    c = ReaderConfig(**PULSE_GEOMETRIES[name])
    nt1 = c.n_samples_t1
    return nt1, c.num_pulses_command, block_size(nt1), pulse_window(c)


def _same_pulses(flags, geo, label):
    from gen2_rfid_tpu_torch.dsp.gate import gate_pulses_plain

    before = kernels.launches["gate_pulses"]
    got = gate_pulses(flags, *geo)
    want = gate_pulses_plain(flags, *geo)
    torch.cuda.synchronize()
    assert kernels.launches["gate_pulses"] == before + 1
    for g, w, what in zip(got, want, ("cand", "pulses", "counts")):
        assert torch.equal(g, w), (label, what)
    return got


@pytest.mark.parametrize("name", list(PULSE_GEOMETRIES))
def test_gate_pulses_kernel_on_the_cases(cuda, name):
    """Bit-equal to the plain version on every input that stresses the
    tiles (``pulse_cases``: resets on tile and halo edges, no reset for
    more than the window, rises only in the halo, n below the window, n a
    multiple of neither block nor tile, dense rises, a count at the invalid
    slots' sample) and on random flags."""
    geo = _pulse_geometry(name)
    cases = pulse_cases(geo[0], geo[3], geo[2], seed=11)
    for label, flags in cases + [("random", random_flags(300_007, 1))]:
        _same_pulses(flags.to(cuda), geo, label)


def test_gate_pulses_geometry_is_the_models(cuda):
    """The built kernel tiles as the Python model (``tile_geometry``, which
    ``pulse_cases`` places its edges by) at every window and block, and
    refuses what it refuses."""
    for window in (128, 1024, 2048, 4096, 8192, 16384, 32768, 65536):
        for bsz in (4, 8, 64, 256, 512):
            assert kernel_geometry(window, bsz) == tile_geometry(window, bsz), (window, bsz)
    for bad in ((1000, 64), (1024, 48), (1024, 1024), (1 << 18, 64)):
        with pytest.raises(ValueError):
            kernel_geometry(*bad)
        with pytest.raises(ValueError):
            tile_geometry(*bad)


def test_gate_pulses_kernel_at_the_cell_length(cuda):
    """The benchmark cell's Ny, 46.6 M samples, drawn on the card at the
    rates of a capture's flags and denser: bit-equal to the plain version."""
    n = 232_903_296 // 5
    geo = _pulse_geometry("reader")
    g = torch.Generator(device=cuda).manual_seed(5)
    for rise in (0.02, 0.3):
        r = torch.rand(n, device=cuda, generator=g) < rise
        q = r & (torch.rand(n, device=cuda, generator=g) >= 0.01)
        m = torch.rand(n, device=cuda, generator=g) < 0.0005
        z = torch.rand(n, device=cuda, generator=g) < 0.2
        flags = (r.int() + 2 * q.int() + 4 * m.int() + 8 * z.int()).to(torch.int32)
        _, _, counts = _same_pulses(flags, geo, f"cell length, rise {rise}")
        assert int(counts[0]) > 0


def _gate_inputs(name):
    """(cfg, planar capture) of a decode whose gate the card must match."""
    from gen2_rfid_tpu_torch.runtime.inventory import to_planar
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import golden_trace, synthesize_inventory

    if name == "golden":
        return CFG, to_planar(golden_trace(CFG).iq)
    if name == "miller":
        c = ReaderConfig(miller_m=4, adc_rate=4e6, decim=2, max_events=64, track_channel=True)
        tag = Tag.with_id(27, seed=7, blf_offset=0.02)
    else:
        c = ReaderConfig(adc_rate=8e6, decim=1, max_events=64)
        tag = Tag.with_id(27, seed=7)
    return c, to_planar(synthesize_inventory(c, [tag], n_rounds=3, seed=1).iq)


@pytest.mark.parametrize("name", ["golden", "miller", "fm0_8msps"])
def test_gate_events_and_stats_on_card(cuda, name):
    """The native gate on the card (one gate_pulses launch) gives the CPU's
    GateEvents: every integer field equal, DC and noise within summation
    order; the decode's InventoryStats equal the CPU's."""
    from gen2_rfid_tpu_torch.dsp.gate import gate_detect
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_y_for_cfg
    from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_for_cfg
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar
    from torch_compare import assert_same_events

    c, x2 = _gate_inputs(name)
    events = []
    for dev in (cuda, torch.device("cpu")):
        y2 = gate_front_y_for_cfg(x2.to(dev), c)
        before = kernels.launches["gate_pulses"]
        ev = gate_detect(torch.complex(y2[0], y2[1]), c, gate_stack_for_cfg(y2, c))
        assert kernels.launches["gate_pulses"] == before + (dev.type == "cuda")
        events.append(type(ev)(*(t.cpu() for t in ev)))
    assert int(events[1].n_events) > 0
    assert_same_events(*events)
    before = dict(kernels.launches)
    st, _ = decode_capture_planar(x2.to(cuda), c)
    torch.cuda.synchronize()
    assert kernels.launches["gate_pulses"] == before["gate_pulses"] + 1
    st_c, _ = decode_capture_planar(x2, c, device="cpu")
    _same_int_fields(st, st_c)


def test_gate_pulses_not_in_compat_or_the_exact_gate(cuda):
    """Compat mode and the exact gate run no gate_pulses; the native decode
    of the same capture one."""
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar

    c, x2 = _gate_inputs("golden")
    x2 = x2.to(cuda)
    for cfg, exact, want in ((c, False, 1), (ReaderConfig(mode="compat"), False, 0),
                             (c, True, 0), (ReaderConfig(mode="compat"), True, 0)):
        before = kernels.launches["gate_pulses"]
        st, _ = decode_capture_planar(x2, cfg, exact_gate=exact)
        torch.cuda.synchronize()
        assert kernels.launches["gate_pulses"] == before + want, (cfg.mode, exact)
        assert int(st.n_epc_correct) == 70


@pytest.mark.parametrize("shape", [(8, 128), (1,), (3, 7), (1 << 20,)])
def test_probe_kernel_matches_plain(cuda, shape):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(cuda)
    before = kernels.launches["probe"]
    got = probe(x)
    torch.cuda.synchronize()
    assert kernels.launches["probe"] == before + 1
    assert torch.equal(got, probe_plain(x))
    assert torch.equal(probe(x[..., 1:]), probe_plain(x[..., 1:]))   # unaligned view


# ---- Miller, wideband and stream paths -----------------------------------------

# bench_configs.py's Miller geometries: gate_front's runtime-bound build and
# gate_stack's segment kernel.
MILLER_WIDTHS = [dict(miller_m=4, decim=1), dict(miller_m=2, decim=2),
                 dict(miller_m=8, trext=1, adc_rate=8e6, decim=2)]


@pytest.mark.parametrize("kw", MILLER_WIDTHS, ids=["miller4", "miller2", "miller8_trext"])
def test_kernels_at_miller_widths(cuda, kw):
    from gen2_rfid_tpu_torch.kernels.gate_front import front_taps

    c = ReaderConfig(**kw)
    geo = (c.decim, front_taps(c), c.win_length, c.dc_length)
    x2 = torch.from_numpy(_noise(200_003, 11)).to(cuda)
    for g, w in zip(gate_front(x2, *geo), gate_front_plain(x2, *geo)):
        assert torch.equal(g, w), geo
    geo_s = (c.win_length, c.n_samples_pw // 2, c.n_samples_t1, c.thresh_fraction)
    y2 = burst_capture(100_001, 3).to(cuda)
    assert torch.equal(gate_stack_flags(y2, *geo_s), gate_stack_plain(y2, *geo_s)), geo_s


@pytest.mark.parametrize("adc", [10e6, 16e6])
def test_gate_front_kernel_at_high_rates(cuda, adc):
    """At 10 and 16 Msps, decim 1 (W 2500 and 4000): the tile's halo needs
    more y passes than ReaderConfig's; the wrapper's tile is BLOCK_Y."""
    from gen2_rfid_tpu_torch.kernels.gate_front import fitting_block_y, front_taps

    c = ReaderConfig(adc_rate=adc, decim=1)
    geo = (c.decim, front_taps(c), c.win_length, c.dc_length)
    assert fitting_block_y(*geo) == BLOCK_Y
    x2 = torch.from_numpy(_noise(300_007, 13)).to(cuda)
    for g, w in zip(gate_front(x2, *geo), gate_front_plain(x2, *geo)):
        assert torch.equal(g, w), geo


# What a decode reads from an event's window; the other fields of
# DecodedEvents come from the gate.
WINDOW_PRODUCTS = ("rn16_bits", "epc_bits", "epc_pass", "tag_id", "slot_state")


def _same_int_fields(got, want, invalid_rows=True):
    """Every int/bool field equal; with ``invalid_rows=False`` the window
    products of invalid (padding) rows are left out (ROADMAP.md section 3,
    item 12)."""
    valid = getattr(want, "valid", None)
    for f in got._fields:
        a, b = getattr(got, f).cpu(), getattr(want, f)
        if not invalid_rows and f in WINDOW_PRODUCTS:
            a, b = a[valid], b[valid]
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b), f


def test_miller_decode_on_card(cuda):
    """A tracked Miller-4 capture with a 2% BLF error: through one launch of
    each front kernel, equal to the CPU decode on every int/bool field."""
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    c = ReaderConfig(miller_m=4, adc_rate=4e6, decim=2, max_events=64, track_channel=True)
    tr = synthesize_inventory(c, [Tag.with_id(27, seed=7, blf_offset=0.02)], n_rounds=3, seed=1)
    x2 = to_planar(tr.iq)
    before = dict(kernels.launches)
    st, dec = decode_capture_planar(x2.to(cuda), c)
    torch.cuda.synchronize()
    assert kernels.launches["gate_front"] == before["gate_front"] + 1
    assert kernels.launches["gate_stack"] == before["gate_stack"] + 1
    assert kernels.launches["gate_scan"] == before["gate_scan"]
    assert kernels.launches["gate_pulses"] == before["gate_pulses"] + 1
    assert int(st.n_epc_correct) == 3
    st_c, dec_c = decode_capture_planar(x2, c, device="cpu")
    _same_int_fields(dec, dec_c)
    _same_int_fields(st, st_c)


@pytest.mark.parametrize("adc", [8e6, 16e6])
def test_decode_at_high_rates_on_card(cuda, adc):
    """FM0 at 8 and 16 Msps, decim 1 (W 2000 and 4000): through one launch
    of each front kernel, equal to the CPU decode on every int/bool field."""
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    c = ReaderConfig(adc_rate=adc, decim=1, max_events=64)
    tr = synthesize_inventory(c, [Tag.with_id(27, seed=7)], n_rounds=3, seed=1)
    x2 = to_planar(tr.iq)
    before = dict(kernels.launches)
    st, dec = decode_capture_planar(x2.to(cuda), c)
    torch.cuda.synchronize()
    assert kernels.launches["gate_front"] == before["gate_front"] + 1
    assert kernels.launches["gate_stack"] == before["gate_stack"] + 1
    assert kernels.launches["gate_pulses"] == before["gate_pulses"] + 1
    assert int(st.n_epc_correct) == 3 and int(st.tag_reads[27]) == 3
    st_c, dec_c = decode_capture_planar(x2, c, device="cpu")
    _same_int_fields(dec, dec_c)
    _same_int_fields(st, st_c)


# Compat mode and the exact gate at two geometries of chip_smoke.py's phase
# 16b: Miller-4 at decim 1 and FM0 at 8 Msps, decim 1.
GEOMETRY_MODES = {"miller4": dict(miller_m=4, decim=1), "fm0_8msps": dict(adc_rate=8e6, decim=1)}


@pytest.mark.parametrize("name", list(GEOMETRY_MODES))
@pytest.mark.parametrize("mode,exact", [("compat", False), ("native", True), ("compat", True)],
                         ids=["compat", "exact_native", "exact_compat"])
def test_modes_at_native_geometries_on_card(cuda, name, mode, exact):
    """The 3-round capture (tag 27 seed 7, seed 2, a 32-row table): through
    one launch of gate_front's full build and one of compat_gate or
    gate_scan, no gate_stack; every EPC; equal to the CPU decode on every
    int/bool field (at 8 Msps in compat mode but for the window products of
    the 26 padding rows, ROADMAP.md section 3, item 12); the exact gate's
    stats equal to the default gate's."""
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    kw = GEOMETRY_MODES[name]
    tr = synthesize_inventory(ReaderConfig(max_events=32, **kw), [Tag.with_id(27, seed=7)],
                              n_rounds=3, seed=2)
    c = ReaderConfig(mode=mode, max_events=32, **kw)
    x2 = to_planar(tr.iq)
    before = (dict(kernels.launches), dict(kernels.front_bodies))
    st, dec = decode_capture_planar(x2.to(cuda), c, exact_gate=exact)
    torch.cuda.synchronize()
    got = {k: kernels.launches[k] - before[0][k] for k in kernels.launches}
    assert got == {"gate_front": 1, "gate_stack": 0, "gate_scan": int(exact),
                   "compat_gate": int(not exact), "probe": 0, "gate_pulses": 0}
    assert kernels.front_bodies["full"] == before[1]["full"] + 1
    assert int(st.n_epc_correct) == int(st.tag_reads[27]) == 3
    st_c, dec_c = decode_capture_planar(x2, c, exact_gate=exact, device="cpu")
    _same_int_fields(dec, dec_c, invalid_rows=not (name == "fm0_8msps" and mode == "compat"))
    _same_int_fields(st, st_c)
    if exact:
        default, _ = decode_capture_planar(x2.to(cuda), c)
        for f in st._fields:
            assert torch.equal(getattr(st, f), getattr(default, f)), f


def test_channelize_on_card(cuda):
    from gen2_rfid_tpu_torch.dsp.channelizer import channelize_planar

    torch.backends.cuda.matmul.allow_tf32 = False
    x2 = torch.from_numpy(_noise(40_000, 4))
    want = channelize_planar(x2, 8)
    got = channelize_planar(x2.to(cuda), 8).cpu()
    assert float((got - want).abs().max()) <= 5e-6 * float(want.abs().max())


def test_stream_on_card(cuda):
    """The golden trace in 200,000-sample chunks: the batch decode's stats,
    one gate_front, one gate_stack and one gate_pulses launch a chunk."""
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture
    from gen2_rfid_tpu_torch.runtime.stream import StreamDecoder
    from gen2_rfid_tpu_torch.sim.trace import golden_trace

    tr = golden_trace(CFG)
    before = dict(kernels.launches)
    sd = StreamDecoder(CFG, chunk_adc=200_000)
    st, total = sd.decode(iter(np.array_split(tr.iq, 5)))
    torch.cuda.synchronize()
    for k in ("gate_front", "gate_stack", "gate_pulses"):
        assert kernels.launches[k] == before[k] + sd._chunk_no
    _same_int_fields(st, decode_capture(tr.iq, CFG, device="cpu")[0])
    assert int(st.n_epc_correct) == 70


# ---- diversity MRC and EPC-window SIC ---------------------------------------------

def _two_channel_scene():
    """tests/test_diversity.py::test_mrc_clean_exact's capture pair."""
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    cfg = ReaderConfig(max_events=64)
    return cfg, [synthesize_inventory(cfg, [Tag.with_id(27, seed=7, backscatter=bs)], n_rounds=4,
                                      noise=0.004, seed=seed).iq
                 for bs, seed in ((0.08 * np.exp(0.4j), 100), (0.08 * np.exp(-1.7j), 200))]


def test_mrc_decode_on_card(cuda):
    """One gate_front launch a channel, one gate_pulses launch (the gate on
    the channels' combined envelope) and no other kernel; every stats
    field and the event table equal to the CPU decode, the decode products
    on valid events whose windows fit (tests/torch_compare.py), h_chan
    within 1e-4 of its largest magnitude."""
    from gen2_rfid_tpu_torch.runtime.diversity import decode_capture_mrc_full

    cfg, iqs = _two_channel_scene()
    before = dict(kernels.launches)
    st, dec, h = decode_capture_mrc_full(iqs, cfg)
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": 2, "gate_stack": 0, "gate_scan": 0, "compat_gate": 0, "probe": 0,
        "gate_pulses": 1}
    assert int(st.n_epc_correct) == 4
    st_c, dec_c, h_c = decode_capture_mrc_full(iqs, cfg, device="cpu")
    _same_int_fields(st, st_c)
    v = dec_c.valid
    rows = {f: v & dec_c.rn16_fits for f in ("rn16_bits", "slot_state")}
    rows.update({f: v & dec_c.epc_fits for f in ("epc_bits", "epc_pass", "tag_id")})
    for f in dec._fields:
        a, b = getattr(dec, f).cpu(), getattr(dec_c, f)
        if a.dtype in (torch.int32, torch.bool):
            keep = rows.get(f, torch.ones_like(v))
            assert torch.equal(a[keep], b[keep]), f
    keep = v & dec_c.rn16_fits & dec_c.epc_fits
    assert float((h.cpu()[keep] - h_c[keep]).abs().max()) <= 1e-4 * float(h_c[keep].abs().max())


def _sic_scene():
    """tests/test_collision.py::test_batch_epc_sic_recovers_second_tags's
    capture: tags 0x41 and 0x77 with one seed answer every ACK together."""
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    rng = np.random.default_rng(31)

    def mk(tid, bs):
        epc = rng.integers(0, 2, 96)
        for k in range(8):
            epc[88 + k] = (tid >> (7 - k)) & 1
        return Tag(epc96=epc, seed=5, backscatter=bs)

    cfg = ReaderConfig(max_events=64)
    return cfg, synthesize_inventory(cfg, [mk(0x41, 0.09 + 0.02j), mk(0x77, 0.04 - 0.035j)],
                                     n_rounds=4, seed=12)


def test_recover_epc_collisions_on_card(cuda):
    """One gate_front launch inside the recovery; the same (event, tag,
    frame) tuples as the CPU run: tag 0x77 in each of the 4 ACK windows."""
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture
    from gen2_rfid_tpu_torch.runtime.recovery import extra_tag_reads, recover_epc_collisions

    cfg, tr = _sic_scene()
    _, dec = decode_capture(tr.iq, cfg)
    before = kernels.launches["gate_front"]
    got = recover_epc_collisions(tr.iq, dec, cfg)
    torch.cuda.synchronize()
    assert kernels.launches["gate_front"] == before + 1
    _, dec_c = decode_capture(tr.iq, cfg, device="cpu")
    want = recover_epc_collisions(tr.iq, dec_c, cfg, device="cpu")
    assert extra_tag_reads(got) == {0x77: 4}
    assert [(e, t) for e, t, _ in got] == [(e, t) for e, t, _ in want]
    assert all(np.array_equal(a[2], b[2]) for a, b in zip(got, want))


def test_sic_refuses_tf32_and_recovery_turns_it_off(cuda):
    """The SIC library calls raise on CUDA while TF32 matmuls are allowed;
    the entry point recover_epc_collisions turns them off and runs."""
    from gen2_rfid_tpu_torch.dsp.collision import epc_sic_batch, rn16_sic_batch
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture
    from gen2_rfid_tpu_torch.runtime.recovery import recover_epc_collisions

    cfg, tr = _sic_scene()
    frames = torch.zeros((2, cfg.epc_window + 8), dtype=torch.complex64, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for fn in (rn16_sic_batch, epc_sic_batch):
            with pytest.raises(RuntimeError, match="allow_tf32"):
                fn(frames, cfg)
        _, dec = decode_capture(tr.iq, cfg)
        assert len(recover_epc_collisions(tr.iq, dec, cfg)) == 4
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---- the CLI -------------------------------------------------------------------

def test_cli_decode_on_card(cuda, tmp_path, capsys):
    """``decode`` without --device decodes on the card: the golden tuple
    through one launch each of gate_front, gate_stack and gate_pulses."""
    from gen2_rfid_tpu_torch.apps.reader import main

    path = str(tmp_path / "golden.bin")
    assert main(["golden", path]) == 0
    before = dict(kernels.launches)
    assert main(["decode", path]) == 0
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": 1, "gate_stack": 1, "gate_scan": 0, "compat_gate": 0, "probe": 0,
        "gate_pulses": 1}
    lines = capsys.readouterr().out.splitlines()
    for want in ("| Number of queries/queryreps sent : 71", "| Current Inventory round : 72",
                 "| Correctly decoded EPC : 70", "| Tag ID : 1b  Num of reads : 70"):
        assert want in lines


def test_cli_wideband_turns_tf32_off(cuda, tmp_path, capsys):
    """``main`` is an entry point: with both TF32 flags set before it, it
    clears them, and the channelizer (which refuses TF32) then runs."""
    from gen2_rfid_tpu_torch.apps.reader import main
    from gen2_rfid_tpu_torch.io.tracefile import write_trace
    from torch_compare import two_reader_wideband

    wide, occupied = two_reader_wideband()
    path = str(tmp_path / "wide.bin")
    write_trace(path, wide)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert main(["decode", path, "--wideband", "2", "--max-events", "64"]) == 0
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = capsys.readouterr().out
    for k, tag in occupied.items():
        assert f"=== channel {k} " in out and f"| Tag ID : {tag:x}  Num of reads : 2" in out


# ---- the live loop -------------------------------------------------------------

def test_live_inventory_on_card(cuda):
    """The EPC-window SIC pair's live inventory on the card: every integer
    field of LiveStats equal to the CPU run's ("6 3"), through exactly one
    launch of gate_front, of gate_stack and of gate_pulses a window decode."""
    from gen2_rfid_tpu_torch.tools.live_scenes import DecodeLog, build_scene, integer_fields

    reader, channel, n_rounds = build_scene("sic_pair")
    assert reader.device.type == "cuda"
    decodes = DecodeLog(reader)
    before = dict(kernels.launches)
    st = reader.run_inventory(channel, n_rounds)
    torch.cuda.synchronize()
    n_dec = len(decodes.calls)
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": n_dec, "gate_stack": n_dec, "gate_scan": 0, "compat_gate": 0, "probe": 0,
        "gate_pulses": n_dec}
    reader_c, channel_c, _ = build_scene("sic_pair", device="cpu")
    assert integer_fields(st) == integer_fields(reader_c.run_inventory(channel_c, n_rounds))
    assert (st.n_epc_correct, st.n_epc_sic_second) == (6, 3)


def test_live_sic_refuses_tf32(cuda):
    """A SIC reader on the card refuses at construction while TF32 matmuls
    are allowed, with the SIC calls' message; a reader without SIC runs."""
    from gen2_rfid_tpu_torch.runtime.live import LiveReader

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            LiveReader(CFG, sic=True)
        assert LiveReader(CFG).device.type == "cuda"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---- the sharded decode --------------------------------------------------------

@pytest.mark.parametrize("mode", ["native", "compat"])
def test_sharded_decode_on_card(cuda, mode):
    """A 4-shard decode on a mesh of the card equals the same decode on a
    mesh of the CPU: every int/bool field of the joined tables and of the
    stats, through one gate_front (and, native, one gate_stack) launch a
    shard (compat: one compat_gate launch a shard)."""
    from gen2_rfid_tpu_torch.shard.decode_sharded import decode_capture_sharded
    from gen2_rfid_tpu_torch.shard.mesh import make_mesh
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    cfg = ReaderConfig(mode=mode, max_events=256)
    tr = synthesize_inventory(cfg, [Tag.with_id(42, seed=4)], n_rounds=8, seed=21)
    iq = np.pad(tr.iq, (0, (-tr.iq.size) % (4 * cfg.decim)))[None]
    before = dict(kernels.launches)
    st, dec = decode_capture_sharded(iq, cfg, make_mesh(4, devices=[cuda] * 4))
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": 4, "gate_stack": 4 if mode == "native" else 0, "gate_scan": 0,
        "compat_gate": 4 if mode == "compat" else 0, "probe": 0,
        "gate_pulses": 4 if mode == "native" else 0}
    st_c, dec_c = decode_capture_sharded(iq, cfg, make_mesh(4, devices=["cpu"] * 4))
    for f in dec._fields:
        a = getattr(dec, f).cpu()
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, getattr(dec_c, f)), f
    for f in st._fields:
        assert torch.equal(getattr(st, f).cpu(), getattr(st_c, f)), f
    assert int(st.n_epc_correct[0]) == tr.expected_epc_pass


# One point of each envelope sweep: chip_smoke.py's rows, narrowed, and one
# batch of the softfix campaign.
SWEEP_POINTS = rows({
    "snr": ["--snr", "10"], "sic": ["--trials", "4"], "sic_epc": ["--trials", "2"],
    "classifier": ["--dphi-index", "2"],
    "miller": ["--m", "8", "--blf-off", "0.04", "--interferer", "on", "--cfo", "on"],
    "impair": ["--seeds", "1"], "ranging": ["--hops", "2", "--trials", "1"],
}) + [("softfix", "softfix_false_accept", ["--frames", "4096", "--seed", "1"], 0)]


@pytest.mark.parametrize("label,twin,argv,digits", SWEEP_POINTS,
                         ids=[p[0] for p in SWEEP_POINTS])
def test_sweep_point_on_card(cuda, label, twin, argv, digits):
    """One point of each envelope sweep's twin on the card prints the table
    of its CPU run (integer outcomes equal; ranging's cm to one unit of the
    last digit)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        tables = {dev: run_twin(twin, argv, dev)[0] for dev in ("cuda", "cpu")}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert tables["cuda"] and table_diff(tables["cuda"], tables["cpu"], digits) == []


# ---- the bench twins ---------------------------------------------------------------

BENCH_NARROWED = [("bench", ["--rounds", "4", "--tiles", "2"]),
                  ("bench_configs", ["--rounds", "2", "--tiles", "1"]),
                  ("bench_scaling", ["--rounds", "4"]),
                  ("bench_scaling", ["--positions", "4", "--rounds", "4"])]


@pytest.mark.parametrize("twin,argv", BENCH_NARROWED,
                         ids=["bench", "bench_configs", "bench_scaling", "bench_scaling_positions"])
def test_bench_twin_on_card(cuda, twin, argv):
    """Each bench twin's ``main``, narrowed, on the card: every decode reads
    its capture's EPCs (a wrong count exits 1), the same EPCs as the CPU run
    of the same main, and each line names the card and its power limit."""
    import json

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        lines = {dev: [json.loads(line) for line in
                       run_twin(twin, argv + ["--decodes", "2" if dev == "cuda" else "1"],
                                dev)[0]] for dev in ("cuda", "cpu")}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert len(lines["cuda"]) == len(lines["cpu"]) == (8 if twin == "bench_configs" else 1)
    for got, want in zip(lines["cuda"], lines["cpu"]):
        assert got["metric"] == want["metric"] and got["epcs"] == want["epcs"] > 0
        assert got["device"] == torch.cuda.get_device_name(0) and want["device"] == "cpu"
        assert got["power_limit_w"] is not None and got["decodes"] == 2


# ---- the replay on the card ----------------------------------------------------------

def test_closed_form_replay_on_card_at_the_cell_length(cuda):
    """The closed-form replay's scatter-min at the benchmark cell's table
    length, E 36,864: the first passes of 256 tag ids spread along the
    table, later passes drawn from the ids already read, failed CRCs with
    any id.  The card's stats equal the CPU's replay and the sequential
    scan's, through the closed form."""
    from gen2_rfid_tpu_torch import carry
    from gen2_rfid_tpu_torch.runtime import inventory as inv
    from torch_compare import assert_same_stats, replay_table

    cfg = ReaderConfig(fixed_q=2, max_num_queries=100_000, max_unique_tags=1_000)
    n = 36_864 // 2
    rng = np.random.default_rng(n)
    ids = rng.permutation(256)
    firsts = set(np.sort(rng.choice(np.arange(1, n), 255, replace=False)).tolist()) | {0}
    rows, read = [], 0
    for k in range(n):
        if k in firsts:
            read += 1
            rows += [None, (int(ids[read - 1]), True)]
        elif rng.random() < 0.8:
            rows += [None, (int(ids[rng.integers(0, read)]), True)]
        else:
            rows += [None, (int(rng.integers(0, 256)), False)]
    fields = replay_table(rows, cfg)
    host = carry.decoded_from_numpy(fields)
    before = dict(inv.replays)
    got = inv.replay_inventory(carry.decoded_from_numpy(fields, cuda), cfg)
    torch.cuda.synchronize()
    assert inv.replays == {"closed_form": before["closed_form"] + 1, "scan": before["scan"]}
    want = inv.replay_inventory(host, cfg)
    assert int((want.tag_reads > 0).sum()) == 256
    assert_same_stats(got, want)
    assert_same_stats(got, inv.replay_inventory_scan(host, cfg))


# ---- the span recorder on the card ---------------------------------------------------

SYNC_SPANS = ("gen2.host_read", "gen2.host_copy")
STAGES = ("gen2.front", "gen2.gate", "gen2.decode_events", "gen2.replay")


@pytest.fixture(scope="module")
def bench_workload():
    """The bench capture (9.7 M samples) on the card, decoded once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from gen2_rfid_tpu_torch.tools.bench import FLAGSHIP

    w = FLAGSHIP.workload(torch.device("cuda"))
    assert int(w.decode(w.x2)[0].n_epc_correct) == w.epcs[0]
    torch.cuda.synchronize()
    return w


def test_spans_cover_every_sync_of_a_decode(bench_workload):
    """Each synchronizing call that the sync debug mode reports over one
    decode, past those it reports over an empty block (turning the mode on
    and off), is made inside the recorder's helpers, and there are as many
    as host-sync spans."""
    import collections
    import warnings

    from gen2_rfid_tpu_torch.utils import profiling

    def reported(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                   if "synchroniz" in str(w.message))

    empty = reported(lambda: None)
    with profiling.recording():
        during = reported(lambda: bench_workload.decode(bench_workload.x2))
    syncs = during - empty
    rows = profiling.spans()
    assert [r["name"] for r in rows if r["parent"] is None] == ["gen2.decode_capture"]
    assert sum(syncs.values()) == sum(r["name"] in SYNC_SPANS for r in rows) > 0, syncs
    assert all(loc.rsplit(":", 1)[0].endswith("utils/profiling.py") for loc in syncs), syncs


def test_stage_device_times_sum_to_the_root(bench_workload):
    from gen2_rfid_tpu_torch.utils import profiling

    with profiling.recording():
        bench_workload.decode(bench_workload.x2)
    rows = profiling.spans()
    root = [r for r in rows if r["parent"] is None]
    assert len(root) == 1
    stages = [r for r in rows if r["parent"] == root[0]["index"]]
    assert [r["name"] for r in stages] == list(STAGES)
    total = sum(r["device_ms"] for r in stages)
    assert total == pytest.approx(root[0]["device_ms"], rel=0.05)
    assert root[0]["attrs"]["samples"] == bench_workload.x2.shape[1]
    assert root[0]["attrs"]["segment_allocs"] >= 0


def test_recording_adds_no_sync(bench_workload, tmp_path):
    """Under the profiler (which turns the recorder on) a decode's window
    holds one ``cudaStreamSynchronize`` a host-sync span and no
    ``cudaDeviceSynchronize``: the spans add none."""
    import json

    from torch.profiler import ProfilerActivity, profile, record_function

    from gen2_rfid_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("test.decode"):
            bench_workload.decode(bench_workload.x2)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e["name"] == "test.decode"
               and e.get("cat") == "user_annotation")
    inside = [e for e in events if e.get("cat") == "cuda_runtime"
              and win["ts"] <= e["ts"] <= win["ts"] + win["dur"]]
    names = [e["name"] for e in inside]
    n_spans = sum(r["name"] in SYNC_SPANS for r in profiling.spans())
    assert names.count("cudaDeviceSynchronize") == 0
    assert names.count("cudaStreamSynchronize") == n_spans > 0
