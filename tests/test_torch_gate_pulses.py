"""The native gate's pulse count and block-first triggers on the CPU.

``dsp/gate.py::gate_pulses_plain`` (the CPU path, and the kernel's bit
reference on the card) against the chain it packages, written out here as
the gate ran it before the gate-pulses kernel: the doubling scan over the
command span, the trigger test, the pad and ``amin``, the compaction and the
pulse count gathered at each event.  ``kernels/gate_pulses.py::
gate_pulses_model``, the model of the kernel's tiles, against the plain
version on random flags and on the inputs that stress the tiles
(``pulse_cases``), at the geometries of ``ReaderConfig()``, the Miller-4
benchmark file, 16 Msps and a block under 8 samples.
"""

import numpy as np
import pytest
import torch

from gen2_rfid_tpu_torch import kernels
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp import gate
from gen2_rfid_tpu_torch.kernels.gate_pulses import (
    SMEM_LIMIT, block_step, gate_pulses_model, pulse_cases, random_flags, tile_geometry)
from torch_compare import one_torch_thread  # noqa: F401

# rfidbench/configs/miller4_blf160_2msps.json's reader, as the harness runs it.
MILLER4_FILE = dict(miller_m=4, blf_hz=40e3, dr=1, trext=0, pw_us=12, delim_us=12,
                    trcal_us=133, rtcal_us=72, adc_rate=2e6, decim=1, t1_us=128, t2_us=62)
GEOMETRIES = {
    "reader": {},
    "miller4_file": MILLER4_FILE,
    "fm0_16msps": dict(adc_rate=16e6, decim=1),
    "block_under_8": dict(t1_us=10),
}
WANT = {"reader": (96, 1024, 64), "miller4_file": (256, 4096, 256),
        "fm0_16msps": (3840, 32768, 512), "block_under_8": (4, 1024, 4)}


def _geometry(name, **kw):
    cfg = ReaderConfig(**GEOMETRIES[name], **kw)
    nt1 = cfg.n_samples_t1
    return cfg, (nt1, cfg.num_pulses_command, gate.block_size(nt1), gate.pulse_window(cfg))


def _chain_before(flags, cfg, cap):
    """The native gate's triggers and event table as dsp/gate.py computed
    them before the kernel: (cand, index, n_events, n_pulses)."""
    n = flags.shape[0]
    nt1 = cfg.n_samples_t1
    rise = (flags & 1) != 0
    reset = (rise & ((flags & 2) == 0)) | ((flags & 4) != 0)
    pulses_at = gate._rises_since_reset(rise, reset, gate.command_span(cfg))
    arange = torch.arange(n, dtype=torch.int32)
    trig = (rise & (pulses_at > cfg.num_pulses_command) & ((flags & 8) != 0)
            & (arange + nt1 + 1 < n))
    trig_sample = torch.where(trig, arange + nt1 + 1, n)
    bsz = 1 << max(min(nt1 + 1, 512).bit_length() - 1, 0)
    if bsz >= 8:
        nb = -(-n // bsz)
        s2 = torch.cat([trig_sample, trig_sample.new_full((nb * bsz - n,), n)])
        cand = s2.reshape(nb, bsz).amin(dim=1)
    else:
        cand = trig_sample
    has = cand < n
    pos = torch.cumsum(has.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(has, torch.clamp(pos, max=cap), cap)
    ev = torch.full((cap + 1,), n, dtype=torch.int32).scatter(0, slot.to(torch.int64), cand)[:cap]
    rise_of_ev = torch.clamp(torch.clamp(ev, max=n - 1) - (nt1 + 1), min=0)
    return cand, ev, trig.sum(dtype=torch.int32), pulses_at[rise_of_ev.to(torch.int64)]


def _flags_for(name, seed):
    cfg, geo = _geometry(name)
    halo, tile, _, _ = tile_geometry(geo[3], geo[2])
    return cfg, geo, random_flags(2 * tile + 3 * halo + 13, seed)


def _same(got, want):
    for g, w, what in zip(got, want, ("cand", "pulses", "counts")):
        assert torch.equal(g, w), what


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometries_are_the_ones_named(name):
    _, (nt1, _, bsz, window) = _geometry(name)
    assert (nt1, window, bsz) == WANT[name]
    assert block_step(bsz) == (bsz if bsz >= 8 else 1)


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("seed", [1, 2])
def test_plain_version_equals_the_chain_before(name, seed):
    """Candidate for candidate, with its pulse count, and the trigger count:
    the plain version over the scan's power-of-two reach equals the chain
    over the command span."""
    cfg, geo, flags = _flags_for(name, seed)
    cand, pulses, counts = gate.gate_pulses_plain(flags, *geo)
    want_cand, _, want_trig, _ = _chain_before(flags, cfg, 16)
    assert torch.equal(cand, want_cand)
    assert int(counts[0]) == int(want_trig) > 0
    nt1 = geo[0]
    has = cand < flags.shape[0]
    rise = flags & 1 != 0
    pulses_at = gate._rises_since_reset(rise, (rise & (flags & 2 == 0)) | (flags & 4 != 0),
                                        gate.command_span(cfg))
    assert torch.equal(pulses[has], pulses_at[(cand[has] - nt1 - 1).to(torch.int64)])
    assert not bool(pulses[~has].any())
    assert int(counts[1]) == int(pulses_at[max(flags.shape[0] - nt1 - 2, 0)])


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("cap", [4, 64, 4096])
def test_gate_detect_table_equals_the_chain_before(name, cap):
    """gate_detect on given flags: index, valid, n_events and n_pulses (the
    invalid slots' too, and past capacity) as the gate gave them before."""
    cfg, _, flags = _flags_for(name, 5)
    cfg = ReaderConfig(**GEOMETRIES[name], max_events=cap)
    n = flags.shape[0]
    y = torch.complex(*torch.from_numpy(
        np.random.default_rng(0).normal(size=(2, n)).astype(np.float32)))
    ev = gate.gate_detect(y, cfg, flags)
    _, index, n_events, n_pulses = _chain_before(flags, cfg, cap)
    assert torch.equal(ev.index, index) and torch.equal(ev.valid, index < n)
    assert ev.n_events.dtype == torch.int32 and int(ev.n_events) == int(n_events)
    assert ev.n_pulses.dtype == torch.int32 and torch.equal(ev.n_pulses, n_pulses)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_model_equals_plain_on_the_cases(name):
    """The kernel's model at its tiles against the plain version on every
    input that stresses the tiles."""
    _, geo = _geometry(name)
    for label, flags in pulse_cases(geo[0], geo[3], geo[2], seed=3):
        want = gate.gate_pulses_plain(flags, *geo)
        got = gate_pulses_model(flags, *geo)
        for g, w, what in zip(got, want, ("cand", "pulses", "counts")):
            assert torch.equal(g, w), (label, what)


@pytest.mark.parametrize("n", [1, 2, 97, 98, 99, 1023, 1025])
def test_model_and_plain_at_tiny_lengths(n):
    """Captures shorter than nt1 + 2 (no trigger fits; the invalid slots'
    sample is 0) and around it."""
    _, geo = _geometry("reader")
    flags = random_flags(n, n, rise=0.4)
    _same(gate_pulses_model(flags, *geo), gate.gate_pulses_plain(flags, *geo))


def test_tile_geometry():
    """Halo >= window, tile a multiple of the block, shared memory within
    the card's 227 KB at every geometry ReaderConfig gives at 2-16 Msps;
    windows and blocks that are not powers of two refused."""
    for kw in (dict(), dict(miller_m=2), dict(miller_m=4, decim=1), dict(miller_m=8, trext=1),
               dict(adc_rate=4e6, decim=1), dict(adc_rate=8e6, decim=1),
               dict(adc_rate=16e6, decim=1), MILLER4_FILE):
        cfg = ReaderConfig(**kw)
        bsz, window = gate.block_size(cfg.n_samples_t1), gate.pulse_window(cfg)
        halo, tile, wpt, smem = tile_geometry(window, bsz)
        assert halo >= window and tile % bsz == 0 and tile >= 3 * halo - 1024
        assert halo + tile == 32 * 256 * wpt and smem <= SMEM_LIMIT
    assert tile_geometry(1024, 64) == (1024, 15360, 2, 10112)
    assert tile_geometry(32768, 512)[:3] == (32768, 98304, 16)
    for bad in ((1000, 64), (1024, 48), (1024, 1024), (1 << 18, 64)):
        with pytest.raises(ValueError):
            tile_geometry(*bad)


def test_cpu_gate_detect_launches_nothing():
    kernels.reset_launches()
    cfg, _, flags = _flags_for("reader", 9)
    y = torch.zeros(flags.shape[0], dtype=torch.complex64)
    gate.gate_detect(y, cfg, flags)
    assert kernels.launches["gate_pulses"] == 0
