"""Miller-M captures decoded whole by the port, on the CPU: against the JAX
package (native, compat, ``exact_gate=True``), against the simulator's
truth at tests/test_miller.py's geometries, and the pinned
``miller4_impaired`` SigMF fixture.

Integer and bool outputs must be equal to the JAX package's; floats agree
as tests/torch_compare.py states.  The JAX package's whole-capture Miller
decodes compile for seconds each, so this file runs three of them.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.runtime import softfix as ref_softfix
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.io.sigmf import load_sigmf
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime import softfix
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory as port_synthesize
from gen2_rfid_tpu_torch.tools.fixtures import fixture_specs
from torch_compare import assert_same_decoded, assert_same_stats, port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "miller4_impaired"

ref_decode = jax.jit(ref_inv.decode_capture_planar, static_argnames=("cfg", "exact_gate"))


def _against_jax(ref_cfg, tag, exact_gate=False, n_rounds=3, seed=1):
    tr = synthesize_inventory(ref_cfg, [tag], n_rounds=n_rounds, seed=seed)
    stats, dec = inv.decode_capture(tr.iq, port_cfg(ref_cfg), exact_gate=exact_gate,
                                    device="cpu")
    ref_stats, ref_dec = ref_decode(ref_inv.to_planar(tr.iq), ref_cfg, exact_gate=exact_gate)
    assert_same_stats(stats, ref_stats)
    assert_same_decoded(dec, ref_dec)
    assert int(stats.n_epc_correct) == tr.expected_epc_pass == n_rounds
    return stats, dec


# ---- the port alone, against the simulator's truth -------------------------

@pytest.mark.parametrize("kw", [
    dict(miller_m=2, adc_rate=2e6, decim=2), dict(miller_m=2, adc_rate=2e6, decim=5),
    dict(miller_m=4, adc_rate=4e6, decim=2), dict(miller_m=8, adc_rate=8e6, decim=2),
    dict(miller_m=2, adc_rate=2e6, decim=2, trext=1),
    dict(miller_m=4, adc_rate=4e6, decim=2, trext=1)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_miller_decode_geometries(kw):
    """tests/test_miller.py's geometries and TRext: every query and EPC, and
    each RN16 equal to the one the tag sent."""
    cfg = ReaderConfig(max_events=64, **kw)
    tr = port_synthesize(cfg, [Tag.with_id(27, seed=7)], n_rounds=3, seed=1)
    stats, dec = inv.decode_capture(tr.iq, cfg, device="cpu")
    assert int(stats.n_queries) == 3 and int(stats.n_epc_correct) == 3
    assert int(stats.tag_reads[27]) == 3
    rn16 = dec.rn16_bits.numpy()[dec.valid.numpy()]
    queries = [e for e in tr.events if e.kind in ("query", "query_rep")]
    for k, ev in enumerate(queries):
        np.testing.assert_array_equal(rn16[2 * k], ev.reply_bits)


@pytest.mark.parametrize("m,adc,decim,offsets", [
    (2, 2e6, 2, (-0.04, 0.04)), (8, 8e6, 2, (-0.03, 0.04)), (8, 2e6, 1, (-0.02, 0.02))])
def test_blf_offset_tolerance(m, adc, decim, offsets):
    """tests/test_miller.py's envelope: BLF error through +-4% decodes exactly
    (M=8 at decim 1 runs the 0.25-sample offset lattice)."""
    cfg = ReaderConfig(miller_m=m, adc_rate=adc, decim=decim, max_events=64)
    for off in offsets:
        tr = port_synthesize(cfg, [Tag.with_id(27, seed=7, blf_offset=off)], n_rounds=2,
                             seed=5)
        stats, _ = inv.decode_capture(tr.iq, cfg, device="cpu")
        assert int(stats.n_epc_correct) == 2, off


def test_tracking_rides_cfo():
    """Channel tracking holds a 1.6 kHz CFO that the frozen preamble
    estimate loses (tests/test_miller.py::test_miller_channel_tracking_cfo)."""
    def run(cfo, track):
        cfg = ReaderConfig(miller_m=4, adc_rate=4e6, decim=2, max_events=64,
                           track_channel=track)
        tr = port_synthesize(cfg, [Tag.with_id(27, seed=7, cfo_hz=cfo)], n_rounds=3, seed=1)
        return int(inv.decode_capture(tr.iq, cfg, device="cpu")[0].n_epc_correct)

    assert run(1600.0, True) == 3
    assert run(800.0, False) == 0


def test_miller4_impaired_fixture():
    """The committed SigMF capture (ci16, BLF +1%, 300 Hz CFO, amplitude ramp,
    d = 1.25 samples a chip) decodes to its pinned stats with the fixture's
    own configuration."""
    spec = fixture_specs()["miller4_impaired"]
    cfg = spec["cfg"]
    assert cfg.n_samples_chip == 1.25
    iq, meta = load_sigmf(str(FIXTURE))
    assert meta["global"]["core:sample_rate"] == cfg.adc_rate
    stats, _ = inv.decode_capture(iq, cfg, device="cpu")
    want = json.loads(FIXTURE.with_suffix(".expect.json").read_text())
    reads = stats.tag_reads.numpy()
    assert {"n_queries": int(stats.n_queries), "n_epc_correct": int(stats.n_epc_correct),
            "round": int(stats.cur_inventory_round),
            "tag_reads": {str(t): int(reads[t]) for t in np.nonzero(reads)[0]}} == {
        k: want[k] for k in ("n_queries", "n_epc_correct", "round", "tag_reads")}
    assert (want["n_queries"], want["round"], want["n_epc_correct"], want["tag_reads"]) == (
        5, 6, 5, {"77": 5})


# ---- CRC-guided recovery -----------------------------------------------------

def test_softfix_decode_recovers_weak_frames():
    """With ``epc_softfix=8`` a noisy Miller-2 capture reads more EPCs than the
    plain decode, all of tag 27; a clean capture is unchanged."""
    kw = dict(miller_m=2, adc_rate=2e6, decim=2, max_events=64)
    tr = port_synthesize(ReaderConfig(**kw), [Tag.with_id(27, seed=7)], n_rounds=8, seed=4,
                         noise=0.1)
    plain, _ = inv.decode_capture(tr.iq, ReaderConfig(**kw), device="cpu")
    fixed, _ = inv.decode_capture(tr.iq, ReaderConfig(epc_softfix=8, **kw), device="cpu")
    assert int(plain.n_queries) == int(fixed.n_queries) == 8
    assert int(fixed.n_epc_correct) > int(plain.n_epc_correct)
    assert int(fixed.n_epc_correct) == int(fixed.tag_reads[27])
    clean = port_synthesize(ReaderConfig(**kw), [Tag.with_id(27, seed=7)], n_rounds=3, seed=1)
    a, _ = inv.decode_capture(clean.iq, ReaderConfig(**kw), device="cpu")
    b, _ = inv.decode_capture(clean.iq, ReaderConfig(epc_softfix=8, **kw), device="cpu")
    assert_same_stats(b, a)


def test_softfix_flips_single_miller_bits():
    """Miller's recovery flips single bits (FM0's flips pairs): a frame with
    one or two weak wrong bits is repaired as the JAX package repairs it."""
    ref_cfg = RefConfig(miller_m=4, epc_softfix=8)
    cfg = port_cfg(ref_cfg)
    good = RefTag.with_id(27, seed=3).epc_frame_bits().astype(np.int32)
    rows, rels = [], []
    for flips in ([5], [40, 90], [127], []):
        b = good.copy()
        rel = np.ones(b.size, np.float32)
        for j in flips:
            b[j] ^= 1
            rel[j] = 0.05
        rows.append(b)
        rels.append(rel)
    bits, rel = np.stack(rows), np.stack(rels)
    got_bits, got_fixed = softfix.recover_epc_batch(
        torch.from_numpy(bits), torch.from_numpy(rel), cfg, lambda b: inv._validate_epc(b, cfg))
    want_bits, want_fixed = ref_softfix.recover_epc_batch(
        jnp.asarray(bits), jnp.asarray(rel), ref_cfg,
        lambda b: ref_inv._validate_epc(b, ref_cfg))
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(got_fixed.numpy(), np.asarray(want_fixed))
    assert got_fixed.numpy()[:3].all()
    np.testing.assert_array_equal(got_bits.numpy()[:3], np.stack([good] * 3))


# ---- against the JAX package (last: its CPU client slows the port's ops after it runs)

def test_m4_capture_equals_jax():
    """Native Miller-4 with a +2% BLF error and an 800 Hz CFO, tracked."""
    ref_cfg = RefConfig(miller_m=4, adc_rate=4e6, decim=2, max_events=16, track_channel=True)
    _against_jax(ref_cfg, RefTag.with_id(27, seed=7, blf_offset=0.02, cfo_hz=800.0))


def test_compat_miller_equals_jax():
    """Compat Miller-2: the paranoid decode of every event as both windows."""
    ref_cfg = RefConfig(mode="compat", miller_m=2, adc_rate=2e6, decim=2, max_events=16)
    _against_jax(ref_cfg, RefTag.with_id(27, seed=7))


def test_exact_gate_miller_equals_jax():
    """``exact_gate=True`` on a Miller-8 TRext capture: the FSM oracle's
    events, then the cascade."""
    ref_cfg = RefConfig(miller_m=8, trext=1, adc_rate=8e6, decim=2, max_events=16)
    stats, _ = _against_jax(ref_cfg, RefTag.with_id(27, seed=7), exact_gate=True)
    default, _ = inv.decode_capture(
        synthesize_inventory(ref_cfg, [RefTag.with_id(27, seed=7)], n_rounds=3, seed=1).iq,
        port_cfg(ref_cfg), device="cpu")
    assert_same_stats(stats, default)
