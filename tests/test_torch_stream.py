"""The port's chunked stream decoder (runtime/stream.py) and the pieces of
shard/decode_sharded.py it needs, on the CPU.

Stream stats must equal the batch decode's for every chunk size and feed
split, in native and compat mode and for Miller; a checkpoint saved
mid-stream resumes in a fresh decoder to the same stats.  Checkpoints keep
the JAX package's field names and dtypes: one the JAX StreamDecoder saves
resumes in the port, and the other way round, with equal stats.  The valid
FIR is the in-order tap sum, bit for bit, and within float32 summation
noise (2e-5 of the largest magnitude) of the JAX package's XLA convolution.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp.filters import boxcar_taps, moving_sum
from gen2_rfid_tpu.runtime.stream import StreamDecoder as RefStreamDecoder
from gen2_rfid_tpu.shard import decode_sharded as ref_sharded
from gen2_rfid_tpu_torch import carry
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.kernels.gate_front import front_taps
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime.stream import UNOWNED, StreamDecoder
from gen2_rfid_tpu_torch.shard.decode_sharded import _fir_valid, front_valid, halo_sizes
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
from torch_compare import assert_same_decoded
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = ReaderConfig()
STATS = ("n_queries", "n_epc_correct", "cur_inventory_round", "cur_slot", "tag_reads",
         "n_rounds_closed", "n_slot_empty", "n_slot_single", "n_slot_collision",
         "cmd_counts")


@pytest.fixture(scope="module")
def trace():
    """tests/test_stream_cli.py's capture: 10 rounds of tag 99."""
    return synthesize_inventory(CFG, [Tag.with_id(99, seed=6)], n_rounds=10, seed=33)


@pytest.fixture(scope="module")
def batch_stats(trace):
    return inv.decode_capture(trace.iq, CFG, device="cpu")[0]


def _same(got, want, fields=STATS):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---- halos and the valid FIR ----------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(miller_m=4, adc_rate=4e6, decim=2),
                                dict(blf_hz=640e3, adc_rate=8e6, decim=2),
                                dict(mode="compat")])
def test_halo_sizes_match(kw):
    assert halo_sizes(ReaderConfig(**kw)) == ref_sharded.halo_sizes(RefConfig(**kw))


@pytest.mark.parametrize("kw,n", [(dict(), 40000), (dict(), 40003), (dict(), 25),
                                  (dict(miller_m=4, adc_rate=4e6, decim=2), 9001),
                                  (dict(miller_m=8, adc_rate=2e6, decim=1), 777)])
def test_fir_valid(kw, n):
    """Every valid output, each the in-order sum of its T inputs bit for bit,
    and the JAX package's _fir_valid within float32 summation noise; |y| and
    its windowed sum as the JAX gate takes them from that y."""
    cfg = ReaderConfig(**kw)
    t, decim = front_taps(cfg), cfg.decim
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n)).astype(np.float32)
    y2 = _fir_valid(torch.from_numpy(x), cfg).numpy()
    n_valid = (n - t) // decim + 1
    assert y2.shape == (2, n_valid)
    want = np.zeros((2, n_valid), np.float32)
    for j in range(t):
        want = want + x[:, j: j + (n_valid - 1) * decim + 1: decim]
    np.testing.assert_array_equal(y2, want)
    ref = np.asarray(ref_sharded._fir_valid(jnp.asarray(x[0] + 1j * x[1]),
                                            jnp.asarray(boxcar_taps(t)), decim))
    assert ref.shape == (n_valid,)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(y2[0] + 1j * y2[1], ref, rtol=0, atol=2e-5 * scale)
    _, amp, avgsum = front_valid(torch.from_numpy(x), cfg)
    assert amp.shape == avgsum.shape == (n_valid,)
    # The windowed |y| sum has zero history at y[0], as the JAX gate's
    # moving sum over _fir_valid's y (test_torch_kernels.py's tolerances).
    np.testing.assert_allclose(amp.numpy(), np.abs(ref), rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(avgsum.numpy(),
                               np.asarray(moving_sum(jnp.abs(jnp.asarray(ref)), cfg.win_length)),
                               rtol=2e-5, atol=1e-2)


# ---- stream == batch ------------------------------------------------------------

def test_stream_matches_batch(trace, batch_stats):
    """Awkward feed sizes re-block into 50,000-sample chunks."""
    dec = StreamDecoder(CFG, chunk_adc=50_000, events_per_chunk=64, device="cpu")
    stats, total = dec.decode(iter(np.array_split(trace.iq, 13)))
    assert total == trace.iq.size
    _same(stats, batch_stats)
    assert int(stats.n_epc_correct) == 10 and int(stats.tag_reads[99]) == 10


@pytest.mark.parametrize("chunk", [20_000, 150_000, 400_000])
def test_stream_chunk_size_invariance(trace, batch_stats, chunk):
    dec = StreamDecoder(CFG, chunk_adc=chunk, events_per_chunk=64, device="cpu")
    stats, _ = dec.decode(iter([trace.iq]))
    _same(stats, batch_stats)


@pytest.mark.parametrize("kw", [dict(mode="compat"),
                                dict(miller_m=4, adc_rate=4e6, decim=2, track_channel=True)],
                         ids=["compat", "miller4"])
def test_stream_matches_batch_other_paths(kw):
    cfg = ReaderConfig(max_events=64, **kw)
    tr = synthesize_inventory(cfg, [Tag.with_id(27, seed=7, blf_offset=0.01)], n_rounds=4,
                              seed=2)
    want = inv.decode_capture(tr.iq, cfg, device="cpu")[0]
    chunk = 100_000 - 100_000 % cfg.decim
    stats, _ = StreamDecoder(cfg, chunk_adc=chunk, events_per_chunk=32, device="cpu").decode(
        iter(np.array_split(tr.iq, 3)))
    _same(stats, want)
    assert int(stats.n_epc_correct) == 4


def test_stream_checkpoint_resume(tmp_path, trace, batch_stats):
    a = StreamDecoder(CFG, chunk_adc=40_000, events_per_chunk=64, device="cpu")
    a.reset()
    half = len(trace.iq) // 2
    a.feed(trace.iq[:half])
    ckpt = str(tmp_path / "stream.npz")
    a.save_checkpoint(ckpt)
    b = StreamDecoder(CFG, chunk_adc=40_000, events_per_chunk=64, device="cpu")
    b.load_checkpoint(ckpt)
    b.feed(trace.iq[half:])
    stats, total = b.finish()
    assert total == trace.iq.size
    _same(stats, batch_stats)


def test_bad_chunk_and_no_device_raise(monkeypatch):
    with pytest.raises(ValueError, match="multiple of decim"):
        StreamDecoder(CFG, chunk_adc=200_001, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamDecoder(CFG)


# ---- checkpoints shared with the JAX package --------------------------------------

def test_checkpoints_interchange_with_jax(tmp_path, trace, batch_stats):
    """The JAX decoder's checkpoint resumes in the port and the port's in the
    JAX decoder, to the batch stats; both files hold the same names, dtypes
    and shapes, and equal context, buffer, counts and int/bool tables."""
    kw = dict(chunk_adc=25_000, events_per_chunk=32)
    half = 3 * len(trace.iq) // 5
    ref = RefStreamDecoder(RefConfig(), **kw)
    ref.reset()
    ref.feed(trace.iq[:half])
    ref_ckpt = str(tmp_path / "jax.npz")
    ref.save_checkpoint(ref_ckpt)

    port = StreamDecoder(CFG, device="cpu", **kw)
    port.reset()
    port.feed(trace.iq[:half])
    port_ckpt = str(tmp_path / "port.npz")
    port.save_checkpoint(port_ckpt)

    zr, zp = np.load(ref_ckpt), np.load(port_ckpt)
    assert sorted(zr.files) == sorted(zp.files)
    for name in zr.files:
        assert (zr[name].dtype, zr[name].shape) == (zp[name].dtype, zp[name].shape), name
    for name in ("ctx", "buf", "total_adc", "chunk_no", "n_tables"):
        np.testing.assert_array_equal(zp[name], zr[name], err_msg=name)
    assert int(zr["n_tables"]) >= 2
    for i in range(int(zr["n_tables"])):
        table = {f: zr[f"t{i}_{f}"] for f in inv.DecodedEvents._fields}
        assert np.all(table["index"][~table["valid"]] == UNOWNED)
        assert_same_decoded(carry.decoded_from_numpy(
            {f: zp[f"t{i}_{f}"] for f in inv.DecodedEvents._fields}),
            SimpleNamespace(**table))

    resumed = StreamDecoder(CFG, device="cpu", **kw)
    resumed.load_checkpoint(ref_ckpt)
    resumed.feed(trace.iq[half:])
    stats, total = resumed.finish()
    assert total == trace.iq.size
    _same(stats, batch_stats)

    back = RefStreamDecoder(RefConfig(), **kw)
    back._decode = ref._decode          # the compiled chunk decode, reused
    back.load_checkpoint(port_ckpt)
    back.feed(trace.iq[half:])
    ref_stats, ref_total = back.finish()
    assert ref_total == trace.iq.size
    _same(ref_stats, batch_stats)
