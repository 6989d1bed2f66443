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
from gen2_rfid_tpu_torch.kernels.gate_front import BLOCK_Y, gate_front, gate_front_plain
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


def _same_int_fields(got, want):
    for f in got._fields:
        a, b = getattr(got, f).cpu(), getattr(want, f)
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
    assert int(st.n_epc_correct) == 3 and int(st.tag_reads[27]) == 3
    st_c, dec_c = decode_capture_planar(x2, c, device="cpu")
    _same_int_fields(dec, dec_c)
    _same_int_fields(st, st_c)


def test_channelize_on_card(cuda):
    from gen2_rfid_tpu_torch.dsp.channelizer import channelize_planar

    torch.backends.cuda.matmul.allow_tf32 = False
    x2 = torch.from_numpy(_noise(40_000, 4))
    want = channelize_planar(x2, 8)
    got = channelize_planar(x2.to(cuda), 8).cpu()
    assert float((got - want).abs().max()) <= 5e-6 * float(want.abs().max())


def test_stream_on_card(cuda):
    """The golden trace in 200,000-sample chunks: the batch decode's stats,
    one gate_front and one gate_stack launch a chunk."""
    from gen2_rfid_tpu_torch.runtime.inventory import decode_capture
    from gen2_rfid_tpu_torch.runtime.stream import StreamDecoder
    from gen2_rfid_tpu_torch.sim.trace import golden_trace

    tr = golden_trace(CFG)
    before = dict(kernels.launches)
    sd = StreamDecoder(CFG, chunk_adc=200_000)
    st, total = sd.decode(iter(np.array_split(tr.iq, 5)))
    torch.cuda.synchronize()
    for k in ("gate_front", "gate_stack"):
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
    """One gate_front launch a channel and no other kernel; every stats
    field and the event table equal to the CPU decode, the decode products
    on valid events whose windows fit (tests/torch_compare.py), h_chan
    within 1e-4 of its largest magnitude."""
    from gen2_rfid_tpu_torch.runtime.diversity import decode_capture_mrc_full

    cfg, iqs = _two_channel_scene()
    before = dict(kernels.launches)
    st, dec, h = decode_capture_mrc_full(iqs, cfg)
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": 2, "gate_stack": 0, "gate_scan": 0, "probe": 0}
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
    through one launch each of gate_front and gate_stack."""
    from gen2_rfid_tpu_torch.apps.reader import main

    path = str(tmp_path / "golden.bin")
    assert main(["golden", path]) == 0
    before = dict(kernels.launches)
    assert main(["decode", path]) == 0
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": 1, "gate_stack": 1, "gate_scan": 0, "probe": 0}
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
    launch of gate_front and of gate_stack a window decode."""
    from gen2_rfid_tpu_torch.tools.live_scenes import DecodeLog, build_scene, integer_fields

    reader, channel, n_rounds = build_scene("sic_pair")
    assert reader.device.type == "cuda"
    decodes = DecodeLog(reader)
    before = dict(kernels.launches)
    st = reader.run_inventory(channel, n_rounds)
    torch.cuda.synchronize()
    n_dec = len(decodes.calls)
    assert {k: kernels.launches[k] - before[k] for k in before} == {
        "gate_front": n_dec, "gate_stack": n_dec, "gate_scan": 0, "probe": 0}
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
    shard."""
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
        "gate_front": 4, "gate_stack": 4 if mode == "native" else 0, "gate_scan": 0, "probe": 0}
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
