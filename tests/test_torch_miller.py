"""The port's Miller-M sync and segment cascade (dsp/miller.py) against the
JAX package's, function by function, on the CPU.

Frames are the decode windows of small synthesized captures (the port's
front end and gate; only windows of real events).  Sync indices, the sync's
chip-period estimate and every decoded bit must be equal; h_est agrees to
1e-5 of its largest magnitude (the JAX package contracts selection matrices
in float32, the port sums in float64 and rounds once); chip estimates,
margins and reliabilities to 1e-5 relative (the same terms summed in
another float32 order).  The tables are held to the JAX package's: the
segment positions rebuild its dense selection tables exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import miller as ref_miller
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.dsp import miller
from gen2_rfid_tpu_torch.dsp.gate import gate_detect
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime.frames import GRANULE, extract_windows
from gen2_rfid_tpu_torch.runtime.inventory import to_planar
from torch_compare import port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

GEOMETRIES = {
    "m2": dict(miller_m=2, adc_rate=2e6, decim=2),
    "m2_decim5": dict(miller_m=2, adc_rate=2e6, decim=5),
    "m4": dict(miller_m=4, adc_rate=4e6, decim=2),
    "m8": dict(miller_m=8, adc_rate=8e6, decim=2),
    "m4_trext": dict(miller_m=4, adc_rate=4e6, decim=2, trext=1),
    "m8_trext": dict(miller_m=8, adc_rate=8e6, decim=2, trext=1),
    # d = 3.125 samples a chip: 0.25-sample offset steps.
    "m8_d3": dict(miller_m=8, adc_rate=2e6, decim=1),
}


def _frames(ref_cfg, tag_kw=None, seed=1, n_rounds=2):
    """(port cfg, frames (E, W) of the real events, magn2)."""
    cfg = port_cfg(ref_cfg)
    tag = RefTag.with_id(27, seed=7, **(tag_kw or {}))
    tr = synthesize_inventory(ref_cfg, [tag], n_rounds=n_rounds, seed=seed)
    y2 = gate_front_for_cfg(to_planar(tr.iq), cfg)[0]
    y = torch.complex(y2[0], y2[1])
    ev = gate_detect(y, cfg)
    frames, magn2, _, epc_fits = extract_windows(y, ev, cfg)
    keep = ev.valid & epc_fits
    assert int(keep.sum()) >= 2
    return cfg, frames[keep], magn2[keep]


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


# ---- tables -----------------------------------------------------------------

@pytest.mark.parametrize("m,trext", [(2, 0), (4, 0), (8, 0), (2, 1), (8, 1)])
def test_preamble_and_grids_match(m, trext):
    np.testing.assert_array_equal(miller._preamble_pm(m, trext), ref_miller._preamble_pm(m, trext))
    assert miller.default_seg_bits(m) == ref_miller.default_seg_bits(m)
    for frac in (0.01, 0.04, 0.1):
        np.testing.assert_array_equal(miller.sync_eps_grid(frac), ref_miller.sync_eps_grid(frac))
        np.testing.assert_array_equal(miller.seg_eps_grid(frac), ref_miller.seg_eps_grid(frac))
    ref_cfg = RefConfig(miller_m=m, trext=trext, adc_rate=4e6, decim=2)
    assert miller.preamble_len_samples(port_cfg(ref_cfg)) == \
        ref_miller.preamble_len_samples(ref_cfg)


@pytest.mark.parametrize("name", ["m2", "m4_trext", "m8_d3"])
def test_sync_tables_match(name):
    """The correlation table is the JAX package's; its channel-mean table is
    the positions and weights the port gathers with."""
    ref_cfg = RefConfig(**GEOMETRIES[name])
    s, span, dshift, n_off, eps, pos, w = miller._sync_tables(port_cfg(ref_cfg))
    r_s, r_sh, r_span, r_dshift, r_n_off, r_eps = ref_miller._miller_sync_selection(ref_cfg)
    np.testing.assert_array_equal(s, r_s)
    assert (span, n_off) == (r_span, r_n_off)
    np.testing.assert_array_equal(dshift, r_dshift)
    np.testing.assert_array_equal(eps, r_eps)
    sh = np.zeros_like(r_sh)
    for t in range(eps.shape[0]):
        for j in range(pos.shape[1]):
            np.add.at(sh, (pos[t, j] + np.arange(n_off), t * n_off + np.arange(n_off)), w[j])
    np.testing.assert_array_equal(sh, r_sh)


@pytest.mark.parametrize("name,n_bits", [("m2", 16), ("m4", 128), ("m8_d3", 16),
                                         ("m8_trext", 65)])
def test_segment_positions_rebuild_the_selection_tables(name, n_bits):
    """Scattering +-1 at the positions gives the JAX package's dense tables
    exactly (no two chips of a column share a sample), slice starts and
    spans included; at d < 4 the offset lattice steps 0.25 samples."""
    ref_cfg = RefConfig(**GEOMETRIES[name])
    cfg = port_cfg(ref_cfg)
    m = cfg.miller_m
    seg_bits = miller.default_seg_bits(m)
    tables, eps, offs = miller.segment_positions(cfg, n_bits, seg_bits, 1.5)
    r_tables, r_eps, r_offs = ref_miller._miller_segment_selection(ref_cfg, n_bits, seg_bits, 1.5)
    np.testing.assert_array_equal(eps, r_eps)
    np.testing.assert_array_equal(offs, r_offs)
    assert len(tables) == len(r_tables)
    sub = (-1.0) ** np.arange(m)
    for (s0, span, rel), (r_s0, r_span, r_d) in zip(tables, r_tables):
        assert (s0, span) == (r_s0, r_span)
        n_eps, n_off, n_half, _ = rel.shape
        cols = np.arange(n_eps * n_off * n_half).reshape(n_eps, n_off, n_half, 1)
        dense = np.zeros_like(r_d)
        np.add.at(dense, (rel, np.broadcast_to(cols, rel.shape)),
                  np.broadcast_to(sub, rel.shape).astype(np.float32))
        np.testing.assert_array_equal(dense, r_d)
        assert np.all(np.diff(np.sort(rel, axis=-1), axis=-1) > 0)
    if cfg.n_samples_chip < 4:
        assert float(offs[1] - offs[0]) == 0.25


@pytest.mark.parametrize("name", ["m2", "m8_d3"])
def test_offset_prior_table(name):
    """The (GRANULE, n_off) prior equals the JAX package's expression for
    every remainder, to the last bits of its exponential."""
    ref_cfg = RefConfig(**GEOMETRIES[name])
    cfg = port_cfg(ref_cfg)
    seg_bits = miller.default_seg_bits(cfg.miller_m)
    tab = miller.offset_prior_table(cfg, 16, seg_bits, 1.5)
    _, _, off_np = ref_miller._miller_segment_selection(ref_cfg, 16, seg_bits, 1.5)
    d = np.float32(ref_cfg.n_samples_chip)
    grid = jnp.asarray(off_np / float(d))
    for rem in range(GRANULE):
        rel = grid - jnp.float32(rem) / d
        want = jnp.where(jnp.abs(rel) <= np.float32(1.5 + 0.26 / d),
                         jnp.exp(-(rel ** 2) / (2.0 * 1.25 ** 2)), 0.0)
        np.testing.assert_array_equal(tab[rem] == 0, np.asarray(want) == 0)
        np.testing.assert_allclose(tab[rem], np.asarray(want), rtol=4e-7, atol=0)


# ---- sync and cascade on real frames -----------------------------------------

def _ref_sync(frames, ref_cfg):
    return jax.jit(ref_miller.miller_sync_full_batch, static_argnums=1)(
        jnp.asarray(frames.numpy()), ref_cfg)


def _ref_detect(frames, index, h, ref_cfg, n_bits, eps0):
    f = jnp.asarray(frames.numpy())
    if eps0 is None:
        fn = jax.vmap(lambda fr, i, hh: ref_miller.miller_detect(fr, i, hh, ref_cfg, n_bits))
        return jax.jit(fn)(f, index, h)
    fn = jax.vmap(lambda fr, i, hh, e: ref_miller.miller_detect(fr, i, hh, ref_cfg, n_bits,
                                                                eps0=e))
    return jax.jit(fn)(f, index, h, eps0)


def _check_detect(frames, sync_out, ref_sync_out, ref_cfg, n_bits, seeded):
    cfg = port_cfg(ref_cfg)
    index, h, eps = sync_out
    r_index, r_h, r_eps = ref_sync_out
    got = miller.miller_detect(frames, index, h, cfg, n_bits, eps0=eps if seeded else None)
    want = _ref_detect(frames, r_index, r_h, ref_cfg, n_bits, r_eps if seeded else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))      # bits
    for g, w in zip(got[1:], want[1:]):                                     # chip, margin, rel
        _close(g.numpy(), w)
    return got


# (geometry, tag impairments, tracking, also the EPC cascade?): every M,
# TRext, d < 4, +-3% BLF error and tracking; each EPC cascade compiles the
# JAX package's 16-32 dense segment tables, so the EPC runs where it adds a
# case the others do not cover.
SCENARIOS = [
    ("m2", None, False, True),
    ("m2_decim5", None, False, False),
    ("m4", None, False, True),
    ("m4_trext", None, False, False),
    ("m8_trext", None, False, True),
    ("m8_d3", None, False, False),
    ("m2", dict(blf_offset=0.03), False, True),
    ("m8", dict(blf_offset=-0.03), False, False),
    ("m4", dict(blf_offset=-0.03, cfo_hz=800.0), True, True),
    ("m2", dict(cfo_hz=800.0), True, False),
]


@pytest.mark.parametrize("name,tag_kw,track,epc", SCENARIOS,
                         ids=[f"{n}-{k or 'clean'}-{'track' if t else 'plain'}"
                              for n, k, t, _ in SCENARIOS])
def test_sync_and_cascade_match(name, tag_kw, track, epc):
    """Sync, then the RN16 cascade cold and seeded and, where ``epc`` says,
    the EPC cascade seeded (the decode's own routes), tracking on or off."""
    ref_cfg = RefConfig(**GEOMETRIES[name], max_events=16, track_channel=track)
    cfg, frames, _ = _frames(ref_cfg, tag_kw)
    got = miller.miller_sync_full(frames, cfg)
    want = _ref_sync(frames, ref_cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1].numpy(), np.asarray(want[1]))
    for seeded in (False, True):
        _check_detect(frames, got, want, ref_cfg, 16, seeded)
    if epc:
        _, chip, _, _ = _check_detect(frames, got, want, ref_cfg, cfg.epc_data_bits, True)
        assert chip.shape == (frames.shape[0],)


def test_epc_cascade_cold_matches():
    """The EPC cascade acquiring eps cold, at d < 4 with a +2% BLF error."""
    ref_cfg = RefConfig(**GEOMETRIES["m8_d3"], max_events=16)
    cfg, frames, _ = _frames(ref_cfg, dict(blf_offset=0.02))
    got = miller.miller_sync_full(frames, cfg)
    _check_detect(frames, got, _ref_sync(frames, ref_cfg), ref_cfg, cfg.epc_data_bits, False)


def test_wrappers_are_the_cascade():
    """miller_rn16[_soft], miller_epc[_soft] and miller_sync are the cascade's
    and the sync's outputs."""
    ref_cfg = RefConfig(**GEOMETRIES["m4"], max_events=16)
    cfg, frames, _ = _frames(ref_cfg)
    index, h, eps = miller.miller_sync_full(frames, cfg)
    i2, h2 = miller.miller_sync(frames, cfg)
    assert torch.equal(index, i2) and torch.equal(h, h2)
    bits, chip, margin, rel = miller.miller_detect(frames, index, h, cfg, 16, eps0=eps)
    assert torch.equal(miller.miller_rn16(frames, index, h, cfg, eps0=eps), bits)
    b, mg = miller.miller_rn16_soft(frames, index, h, cfg, eps0=eps)
    assert torch.equal(b, bits) and torch.equal(mg, margin)
    ebits, echip, _, erel = miller.miller_detect(frames, index, h, cfg, cfg.epc_data_bits,
                                                 eps0=eps)
    b, c = miller.miller_epc(frames, index, h, cfg, eps0=eps)
    assert torch.equal(b, ebits) and torch.equal(c, echip)
    b, c, r = miller.miller_epc_soft(frames, index, h, cfg, eps0=eps)
    assert torch.equal(b, ebits) and torch.equal(r, erel)


def test_short_frames_raise():
    ref_cfg = RefConfig(**GEOMETRIES["m4"], max_events=16)
    cfg, frames, _ = _frames(ref_cfg)
    with pytest.raises(ValueError, match="preamble search"):
        miller.miller_sync_full(frames[:, :100], cfg)
    index, h, eps = miller.miller_sync_full(frames, cfg)
    with pytest.raises(ValueError, match="spans"):
        miller.miller_detect(frames[:, :200], index, h, cfg, 16, eps0=eps)
