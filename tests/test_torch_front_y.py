"""The front end's y build (kernels/gate_front.py::gate_front_y) on the CPU,
and which build each path takes.

``gate_front_y_plain`` is the full build's y bit for bit (the same taps in
the same order) at every width the decodes use, and the JAX package's
matched filter within float32 summation noise (2e-5 of the largest
magnitude, test_torch_kernels.py's tolerance).  Every path that reads only
y takes the y build (native decodes, MRC, recovery, live native windows,
stream chunks, native shards); compat mode and the exact gate take the full
build.  The decodes still equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp.filters import boxcar_taps as ref_boxcar_taps
from gen2_rfid_tpu.dsp.filters import matched_filter_decimate as ref_mfd
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import golden_trace as ref_golden_trace
from gen2_rfid_tpu.sim.trace import synthesize_inventory as ref_synthesize
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.kernels import gate_front as gf
from gen2_rfid_tpu_torch.kernels.gate_front import (
    front_taps, gate_front_plain, gate_front_y, gate_front_y_plain)
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.shard import decode_sharded as ds
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
from torch_compare import assert_same_decoded, assert_same_stats, port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

# The widths of every native decode shape chip_smoke.py runs: ReaderConfig's
# (bench, golden, live FM0), bench_configs.py's Miller cases, blf640 and
# blf160, and FM0 at 8 and 16 Msps, decim 1.
WIDTHS = {
    "default": dict(),
    "miller2": dict(miller_m=2, decim=2),
    "miller4": dict(miller_m=4, decim=1),
    "miller8_trext": dict(miller_m=8, trext=1, adc_rate=8e6, decim=2),
    "blf640": dict(blf_hz=640e3, adc_rate=8e6, decim=2),
    "blf160": dict(blf_hz=160e3, dr=1, decim=1),
    "fm0_8msps": dict(adc_rate=8e6, decim=1),
    "fm0_16msps": dict(adc_rate=16e6, decim=1),
}


def _geometry(name):
    c = ReaderConfig(**WIDTHS[name])
    return c.decim, front_taps(c), c.win_length, c.dc_length


def _noise(n, seed):
    return np.random.default_rng(seed).normal(size=(2, n)).astype(np.float32)


def _lengths(decim, taps):
    """A regular length, none, fewer samples than the taps, and a length
    that is not a multiple of the decimation."""
    return {"regular": 997 * decim, "empty": 0, "short": taps - 1 + (taps == 1),
            "ragged": 997 * decim + decim - 1 if decim > 1 else 1001}


CASES = [(name, kind) for name in WIDTHS for kind in ("regular", "empty", "short", "ragged")]


@pytest.mark.parametrize("name,kind", CASES, ids=[f"{n}-{k}" for n, k in CASES])
def test_y_plain_is_the_full_builds_y(name, kind):
    """Bit for bit: the full build's y, and the in-order tap sum in numpy."""
    decim, taps, win, dcw = _geometry(name)
    n = _lengths(decim, taps)[kind]
    x = _noise(n, n + decim)
    got = gate_front_y_plain(torch.from_numpy(x), decim, taps)
    ny = n // decim
    assert got.shape == (2, ny) and got.dtype == torch.float32
    assert torch.equal(got, gate_front_plain(torch.from_numpy(x), decim, taps, win, dcw)[0])
    xp = np.concatenate([np.zeros((2, taps - 1), np.float32), x], axis=1)
    want = np.zeros((2, ny), np.float32)
    for j in range(taps):
        want = want + xp[:, j: j + ny * decim: decim]
    np.testing.assert_array_equal(got.numpy(), want)
    # The CPU wrapper is the plain version.
    assert torch.equal(gate_front_y(torch.from_numpy(x), decim, taps), got)


@pytest.mark.parametrize("name", ["default", "miller4", "miller8_trext", "fm0_16msps"])
def test_y_plain_matches_jax_matched_filter(name):
    """The JAX package's default front end (an XLA strided convolution,
    jitted whole) within float32 summation noise."""
    decim, taps, _, _ = _geometry(name)
    x = _noise(4001 * decim + 3, taps)
    y2 = gate_front_y_plain(torch.from_numpy(x), decim, taps).numpy()
    mfd = jax.jit(ref_mfd, static_argnums=2)
    ref = np.asarray(mfd(jnp.asarray(x[0] + 1j * x[1]), jnp.asarray(ref_boxcar_taps(taps)),
                         decim))
    assert ref.shape == (y2.shape[1],)
    atol = 2e-5 * np.abs(ref).max()
    np.testing.assert_allclose(y2[0], ref.real, rtol=0, atol=atol)
    np.testing.assert_allclose(y2[1], ref.imag, rtol=0, atol=atol)


def test_gate_front_y_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="planar"):
        gate_front_y(torch.zeros((3, 100)), 5, 25)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gate_front_y(torch.zeros((2, 100), device="meta"), 5, 25)


# ---- which build each path takes -------------------------------------------------

@pytest.fixture
def builds(monkeypatch):
    """Counts of the front end's builds: every call of the full build's and
    of the y build's wrapper, wherever a module holds them."""
    counts = {"full": 0, "y": 0}

    def counted(fn, build):
        def call(*a, **kw):
            counts[build] += 1
            return fn(*a, **kw)
        return call

    full, y = counted(gf.gate_front, "full"), counted(gf.gate_front_y, "y")
    for mod in (gf, ds):
        monkeypatch.setattr(mod, "gate_front", full)
        monkeypatch.setattr(mod, "gate_front_y", y)
    return counts


def _capture(cfg, n_rounds=2, seed=1):
    return synthesize_inventory(cfg, [Tag.with_id(27, seed=7)], n_rounds=n_rounds, seed=seed).iq


def _decode(mode, exact_gate=False):
    cfg = ReaderConfig(mode=mode, max_events=64)
    st, _ = inv.decode_capture(_capture(cfg), cfg, exact_gate=exact_gate, device="cpu")
    assert int(st.n_epc_correct) == 2
    return 1


def _live(mode):
    from gen2_rfid_tpu_torch.runtime.live import LiveReader
    from gen2_rfid_tpu_torch.sim.channel import SimTagChannel
    from gen2_rfid_tpu_torch.tools.live_scenes import DecodeLog

    cfg = ReaderConfig(mode=mode)
    reader = LiveReader(cfg, device="cpu")
    log = DecodeLog(reader)
    st = reader.run_inventory(SimTagChannel(cfg, [Tag.with_id(27, seed=7)], seed=1), 2)
    assert st.n_epc_correct == 2
    return len(log.calls)


def _mrc():
    from gen2_rfid_tpu_torch.runtime.diversity import decode_capture_mrc_full

    cfg = ReaderConfig(max_events=64)
    iqs = [synthesize_inventory(cfg, [Tag.with_id(27, seed=7, backscatter=bs)], n_rounds=2,
                                noise=0.004, seed=seed).iq
           for bs, seed in ((0.08 * np.exp(0.4j), 100), (0.08 * np.exp(-1.7j), 200))]
    st, _, _ = decode_capture_mrc_full(iqs, cfg, device="cpu")
    assert int(st.n_epc_correct) == 2
    return len(iqs)


def _recovery():
    from gen2_rfid_tpu_torch.runtime.recovery import recover_epc_collisions

    cfg = ReaderConfig(max_events=64)
    iq = _capture(cfg)
    _, dec = inv.decode_capture(iq, cfg, device="cpu")
    assert recover_epc_collisions(iq, dec, cfg, device="cpu") == []
    return 2                                   # the decode's, then the recovery's


def _stream(mode):
    from gen2_rfid_tpu_torch.runtime.stream import StreamDecoder

    cfg = ReaderConfig(mode=mode)
    sd = StreamDecoder(cfg, chunk_adc=100_000, events_per_chunk=64, device="cpu")
    st, _ = sd.decode(iter([_capture(cfg)]))
    assert int(st.n_epc_correct) == 2
    return sd._chunk_no


def _sharded(mode):
    from gen2_rfid_tpu_torch.shard.mesh import make_mesh

    cfg = ReaderConfig(mode=mode, max_events=64)
    iq = _capture(cfg)
    iq = np.pad(iq, (0, (-iq.size) % (4 * cfg.decim)))[None]
    st, _ = ds.decode_capture_sharded(iq, cfg, make_mesh(4, devices=["cpu"] * 4))
    assert int(st.n_epc_correct[0]) == 2
    return 4


# Path -> (its run, returning its count of front-end calls; the build it takes).
PATHS = {
    "native": (lambda: _decode("native"), "y"),
    "compat": (lambda: _decode("compat"), "full"),
    "exact_gate": (lambda: _decode("native", exact_gate=True), "full"),
    "compat_exact_gate": (lambda: _decode("compat", exact_gate=True), "full"),
    "live_native": (lambda: _live("native"), "y"),
    "live_compat": (lambda: _live("compat"), "full"),
    "mrc": (_mrc, "y"),
    "recovery": (_recovery, "y"),
    "stream_native": (lambda: _stream("native"), "y"),
    "stream_compat": (lambda: _stream("compat"), "full"),
    "sharded_native": (lambda: _sharded("native"), "y"),
    "sharded_compat": (lambda: _sharded("compat"), "full"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_each_path_takes_its_build(builds, path):
    """One front-end call a decode, channel, window, chunk or shard, as
    before; the y build wherever only y is read."""
    run, build = PATHS[path]
    calls = run()
    assert calls > 0
    assert builds == {"full": 0, "y": 0, build: calls}


@pytest.mark.parametrize("name", ["default", "miller4", "fm0_8msps"])
def test_fir_valid_is_front_valids_y(name):
    """The sharded decode's native front end (``_fir_valid``, the y build)
    gives the full build's (``front_valid``'s) y bit for bit on a shard's
    extended block."""
    cfg = ReaderConfig(**WIDTHS[name])
    x = torch.from_numpy(_noise(64_000 * cfg.decim + 3, cfg.decim))
    n_block = x.shape[1] // 4
    halo = ds._halo_x(cfg, n_block)
    for t in (0, 2, 3):
        block = ds.extended_block(x, t, n_block, halo)
        y2 = ds._fir_valid(block, cfg)
        assert torch.equal(y2, ds.front_valid(block, cfg)[0])
        assert y2.shape[1] == ds.front_input(block, cfg)[2]


# ---- the decodes against the JAX package -----------------------------------------

ref_decode = jax.jit(ref_inv.decode_capture_planar, static_argnames=("cfg", "exact_gate"))


def _against_jax(ref_cfg, iq):
    stats, dec = inv.decode_capture(iq, port_cfg(ref_cfg), device="cpu")
    ref_stats, ref_dec = ref_decode(ref_inv.to_planar(iq), ref_cfg)
    assert_same_stats(stats, ref_stats)
    assert_same_decoded(dec, ref_dec)
    return stats


def test_golden_decode_equals_jax():
    """The golden trace through the y build: the JAX package's stats and
    events, and the golden tuple."""
    ref_cfg = RefConfig()
    st = _against_jax(ref_cfg, ref_golden_trace(ref_cfg).iq)
    assert (int(st.n_queries), int(st.cur_inventory_round), int(st.n_epc_correct),
            int(st.tag_reads[0x1B])) == (71, 72, 70, 70)


def test_miller4_decode_equals_jax():
    """A small native Miller-4 decode (decim 1, T 6) through the y build."""
    ref_cfg = RefConfig(miller_m=4, decim=1, max_events=16)
    tr = ref_synthesize(ref_cfg, [RefTag.with_id(27, seed=7)], n_rounds=3, seed=1)
    st = _against_jax(ref_cfg, tr.iq)
    assert int(st.n_epc_correct) == tr.expected_epc_pass == 3
