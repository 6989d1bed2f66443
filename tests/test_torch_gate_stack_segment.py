"""The gate-stack kernel's segment walk, modelled on the CPU.

``kernels/gate_stack.py::gate_stack_segment_plain`` runs the CUDA segment
kernel's decomposition in PyTorch: segments of words with their halos,
tiles, a buffer a dyadic level of the tile and the history read back at
its lags, ballot words, and the
last zero and last one of ``above`` carried from tile to tile.  Its flags
must equal ``gate_stack_plain``'s and the JAX oracle's
(``gen2_rfid_tpu/kernels/gate_stack.py::native_flags_reference``, jitted)
exactly, at every width the kernel takes.  ``segment_smem_bytes`` mirrors
the kernel's shared memory, which must fit the card at every width
``ReaderConfig`` gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.kernels.gate_stack import native_flags_reference
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.kernels import gate_stack as gs
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

# The reference configuration of each geometry the cases use.
REF_CFGS = {
    gs.MILLER2: RefConfig(miller_m=2, decim=2),
    gs.BLF160: RefConfig.for_link(blf_hz=160e3, tari_us=24.0, dr=1, adc_rate=2e6, decim=1),
    gs.BLF640: RefConfig(blf_hz=640e3, adc_rate=8e6, decim=2),
    gs.BLF640[:3] + (1.0,): RefConfig(blf_hz=640e3, adc_rate=8e6, decim=2, thresh_fraction=1.0),
    gs.TARI625: RefConfig.for_link(640e3, tari_us=6.25, dr=1, adc_rate=8e6, decim=1),
    gs.M8_BLF320: RefConfig.for_link(320e3, tari_us=12.5, dr=1, miller_m=8, adc_rate=8e6,
                                     decim=1),
    gs.FM0_8M: RefConfig(adc_rate=8e6, decim=1),
    gs.FM0_16M: RefConfig(adc_rate=16e6, decim=1),
}
CASES = gs.segment_cases()
_oracle_jit = jax.jit(native_flags_reference, static_argnums=1)


def _oracle(y2, geo):
    cfg = REF_CFGS[geo]
    assert (cfg.win_length, cfg.n_samples_pw // 2, cfg.n_samples_t1,
            cfg.thresh_fraction) == geo
    y = y2.numpy()
    return np.asarray(_oracle_jit(jnp.asarray(y[0] + 1j * y[1]), cfg))


@pytest.mark.parametrize("label,y2,geo,run", CASES, ids=[c[0] for c in CASES])
def test_model_matches_plain_and_oracle(label, y2, geo, run):
    got = gs.gate_stack_segment_plain(y2, *geo, seg=run)
    want = gs.gate_stack_plain(y2, *geo)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert torch.equal(got, want), (got != want).nonzero().flatten()[:10]
    np.testing.assert_array_equal(got.numpy(), _oracle(y2, geo))


@pytest.mark.parametrize("geo", [gs.MILLER2, gs.BLF640, gs.M8_BLF320],
                         ids=["miller2", "blf640", "miller8_blf320"])
@pytest.mark.parametrize("tile,run", [(64, 1), (128, 3), (1024, 1), (1024, 200)])
def test_model_at_other_tiles_and_segments(geo, tile, run):
    """Tiles smaller than the lags (histories of several tiles), one-word
    segments, and one segment for the whole capture."""
    y2 = gs.burst_capture(6001, tile + run)
    got = gs.gate_stack_segment_plain(y2, *geo, seg=run, tile=tile)
    assert torch.equal(got, gs.gate_stack_plain(y2, *geo))


def test_cases_set_every_flag():
    """The bursts set every bit at each width; the ties, all-above and
    all-below captures give the runs they are named for."""
    by_label = {c[0]: c for c in CASES}
    for label in gs.SEGMENT_GEOS:
        _, y2, geo, _ = by_label[f"{label} bursts n=30001 run=8"]
        flags = gs.gate_stack_plain(y2, *geo)
        assert all(int((flags >> b & 1).sum()) > 0 for b in range(4)), label
    _, y2, geo, _ = by_label["blf640 ties n=5000"]
    flags = gs.gate_stack_plain(y2, *geo)
    assert int(flags[0]) & gs.RISE and not bool(flags[999:].any())
    _, y2, geo, _ = by_label["blf640 all above n=5000"]
    flags = gs.gate_stack_plain(y2, *geo)
    assert bool((flags[960:-961] == gs.MARKER | gs.QUIET).all())
    _, y2, geo, _ = by_label["blf640 all below n=5000"]
    assert not bool(gs.gate_stack_plain(y2, *geo).any())


def test_geometry_of_the_segment():
    """At the blf640 widths (W 1000 = 512+256+128+64+32+8): a buffer for
    levels 0-8, each with a history of 2^j or the combine offset of its set
    bit (992, 960, 896, 768, 512), rounded up to 4; 62 words before a
    segment (999 samples until the sum is exact, 960 of marker lookback)
    and quiet 31 words behind, shifted by 30 words and 1 bit."""
    g = gs.segment_geometry(*gs.BLF640[:3])
    assert g.nlev == 10 and g.off == (-1, -1, -1, 992, -1, 960, 896, 768, 512, 0)
    assert g.hist == (4, 4, 4, 992, 16, 960, 896, 768, 512, 0)
    assert (g.left, g.delay, g.s, g.sh, g.nw) == (62, 31, 30, 1, 64)
    # ReaderConfig's widths and a one-sample window.
    assert gs.segment_geometry(*gs.READER[:3])[3:] == (7, 4, 3, 1, 64)
    assert gs.segment_geometry(1, 0, 0) == (1, (0,), (0,), 1, 1, 0, 1, 64)
    assert gs.segment_geometry(7, 3, 5).hist == (8, 4, 0)


def _reader_widths():
    """Every (W, pw/2, nt1) ReaderConfig gives at 2, 4, 8 and 16 Msps x
    decim 1, 2, 5 x FM0 / Miller 2-8 x BLF 40-640 kHz, at the default Tari
    and at each spec Tari and divide ratio ``for_link`` accepts."""
    widths = {}
    for adc in (2e6, 4e6, 8e6, 16e6):
        for decim in (1, 2, 5):
            for m in (1, 2, 4, 8):
                for blf in (40e3, 80e3, 160e3, 320e3, 640e3):
                    cfgs = [ReaderConfig(blf_hz=blf, miller_m=m, adc_rate=adc, decim=decim)]
                    for tari in (6.25, 12.5, 25.0):
                        for dr in (0, 1):
                            try:
                                cfgs.append(ReaderConfig.for_link(
                                    blf, tari_us=tari, dr=dr, miller_m=m, adc_rate=adc,
                                    decim=decim))
                            except AssertionError:
                                pass
                    for c in cfgs:
                        widths[(c.win_length, c.n_samples_pw // 2, c.n_samples_t1)] = c
    return widths


def test_segment_smem_fits_every_reader_width():
    widths = _reader_widths()
    assert (4000, 100, 3840) in widths and (100, 2, 96) in widths
    for geo in widths:
        assert gs.segment_unsupported(*geo) is None, geo
        assert 0 < gs.segment_smem_bytes(*geo) <= gs.SMEM_LIMIT, geo
    # Worked out from the buffers: 9 x 1024 + 4156 floats, 64 + 3 x 64 words
    # at W 1000; 11 x 1024 + 16612 floats, 64 + 3 x 256 words at W 4000.
    assert gs.segment_smem_bytes(*gs.BLF640[:3]) == 4 * (9 * 1024 + 4156 + 64 + 3 * 64)
    assert gs.segment_smem_bytes(*gs.FM0_16M[:3]) == 4 * (11 * 1024 + 16612 + 64 + 3 * 256)
    assert max(gs.segment_smem_bytes(*g) for g in widths) == gs.segment_smem_bytes(4000, 100, 3840)


def test_what_the_segment_kernel_cannot_take():
    assert "levels" in gs.segment_unsupported(8192, 2, 96)
    assert "tile" in gs.segment_unsupported(100, gs.SEG_TILE, 96)
    assert "shared memory" in gs.segment_unsupported(100, 2, 1_000_000)
    assert "widths" in gs.segment_unsupported(0, 2, 96)
    y2 = torch.zeros(2, 100)
    for kw in (dict(seg=0), dict(tile=48), dict(tile=16)):
        with pytest.raises(ValueError, match="segment model"):
            gs.gate_stack_segment_plain(y2, *gs.BLF640, **kw)
    assert gs.gate_stack_segment_plain(torch.zeros(2, 0), *gs.BLF640).shape == (0,)
