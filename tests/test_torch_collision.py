"""The port's SIC (dsp/collision.py) and EPC-window recovery
(runtime/recovery.py) against the JAX package's, on the CPU.

Windows are tests/test_collision.py's recipes: superposed FM0 replies of two
tags at amplitude ratios 0.7, 0.4 and 0.15, aligned and offset in T1, three
tags for the joint re-fit, Miller M=2 and M=4, and FM0 under TRext.  The JAX
functions run once per shape, on all of a test's windows stacked, from
module-scope fixtures.  Decoded bits and CRC verdicts must be equal; the
complex amplitudes (h1, h1_sync, h2, h_sync) agree to 1e-4 of their largest
magnitude, margins to 1e-3 absolute and the cancelled energy fractions to
1e-4 absolute (float32 contractions summed in another order).  The chip
trains and the template banks are equal.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import collision as ref
from gen2_rfid_tpu.runtime.recovery import recover_epc_collisions as ref_recover
from gen2_rfid_tpu.sim.tag import Tag, fm0_chips, miller_chips, superpose_reply
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch import carry
from gen2_rfid_tpu_torch.dsp import collision
from gen2_rfid_tpu_torch.dsp.filters import matched_filter_decimate
from gen2_rfid_tpu_torch.runtime import recovery
from gen2_rfid_tpu_torch.runtime.inventory import decode_capture, matched_taps, to_planar
from test_collision import _epc_window, _rand_tag, _window
from torch_compare import port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = RefConfig()
BS1 = 0.08 + 0.03j
MILLER = {2: dict(miller_m=2, adc_rate=2e6, decim=2, max_events=64),
          4: dict(miller_m=4, adc_rate=4e6, decim=2, max_events=64)}


def _scaled(bs, ratio):
    """A second tag's backscatter at ``ratio`` of bs's amplitude."""
    return (0.05 - 0.04j) / abs(0.05 - 0.04j) * abs(bs) * ratio


def _same(got, want, exact=(), amplitude=(), margin=(), cancel=(), rows=()):
    """Fields of the port's result against the JAX package's, on ``rows``
    (all by default)."""
    for f in exact:
        np.testing.assert_array_equal(getattr(got, f).numpy()[rows],
                                      np.asarray(getattr(want, f))[rows], err_msg=f)
    for fields, tol, relative in ((amplitude, 1e-4, True), (margin, 1e-3, False),
                                  (cancel, 1e-4, False)):
        for f in fields:
            w = np.asarray(getattr(want, f))[rows]
            scale = max(np.abs(w).max(), 1e-30) if relative else 1.0
            np.testing.assert_allclose(getattr(got, f).numpy()[rows], w, rtol=0,
                                       atol=tol * scale, err_msg=f)


RN16_FIELDS = dict(exact=("bits1", "bits2"), amplitude=("h1", "h1_sync", "h2"),
                   margin=("margin1", "margin2"), cancel=("cancel_ratio",))
# Pass 1 alone: on a clean single-tag window pass 2 decodes what rounding
# leaves of an exact cancellation, which no two summation orders share.
PASS1_FIELDS = dict(exact=("bits1",), amplitude=("h1", "h1_sync"), margin=("margin1",),
                    cancel=("cancel_ratio",))


def _jit(fn):
    """A JAX function jitted whole, the configuration static: one compile,
    several times quicker than dispatching its ops one by one."""
    return jax.jit(fn, static_argnums=1)


def _run_rn16(ref_cfg, wins):
    """(windows, JAX rn16_sic_batch, port rn16_sic_batch) of stacked windows."""
    w = np.stack([np.asarray(x) for x in wins]).astype(np.complex64)
    want = _jit(ref.rn16_sic_batch)(jnp.asarray(w), ref_cfg)
    return w, want, collision.rn16_sic_batch(torch.from_numpy(w), port_cfg(ref_cfg))


# ---- FM0 RN16 windows ------------------------------------------------------------

@pytest.fixture(scope="module")
def fm0_rn16():
    """A clean single tag, then two tags at each ratio, aligned (252.5 us)
    and offset (256.5 us), with noise; their true RN16s."""
    rng = np.random.default_rng(4)
    b = rng.integers(0, 2, 16)
    wins, truth = [_window([(b, BS1, 252.5)])], [(b, None)]
    for ratio in (0.7, 0.4, 0.15):
        for t1b in (252.5, 256.5):
            b1, b2 = rng.integers(0, 2, 16), rng.integers(0, 2, 16)
            wins.append(_window([(b1, BS1, 252.5), (b2, _scaled(BS1, ratio), t1b)],
                                noise=0.004, seed=int(ratio * 10 + t1b)))
            truth.append((b1, b2))
    return _run_rn16(CFG, wins) + (truth,)


def test_rn16_sic_matches_jax(fm0_rn16):
    _, want, got, truth = fm0_rn16
    _same(got, want, rows=0, **PASS1_FIELDS)
    _same(got, want, rows=slice(1, None), **RN16_FIELDS)
    # The scenes separate: pass 1 is the dominant tag on every window, pass
    # 2 the second tag where it is not far below the noise.
    for k, (b1, b2) in enumerate(truth):
        np.testing.assert_array_equal(got.bits1[k].numpy(), b1)
    assert float(got.cancel_ratio[0]) > 0.999
    for k in (1, 2, 3, 4):
        np.testing.assert_array_equal(got.bits2[k].numpy(), truth[k][1])


def test_rn16_sic_one_window_is_the_batch_row(fm0_rn16):
    w, _, batch, _ = fm0_rn16
    one = collision.rn16_sic(torch.from_numpy(w[3]), port_cfg(CFG))
    row = type(batch)(*(v[3] for v in batch))
    _same(one, row, **RN16_FIELDS)


# ---- three tags: the joint re-fit ------------------------------------------------

@pytest.fixture(scope="module")
def three_tags():
    wins, truth = [], []
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        b = [rng.integers(0, 2, 16) for _ in range(3)]
        wins.append(np.asarray(_window(
            [(b[0], BS1, 252.5), (b[1], 0.0854 * 0.5 * np.exp(-1.0j), 255.0),
             (b[2], 0.0854 * 0.25 * np.exp(1.9j), 258.0)], noise=0.004, seed=200 + seed)))
        truth.append(b)
    w = np.stack(wins)
    want = jax.jit(jax.vmap(lambda f: ref.rn16_sic_n(f, CFG, 3)))(jnp.asarray(w))
    got = collision.rn16_sic_n_batch(torch.from_numpy(w), port_cfg(CFG), 3)
    names = ("bits", "h_sync", "margin", "cancel")
    return (types.SimpleNamespace(**dict(zip(names, want))),
            types.SimpleNamespace(**dict(zip(names, got))), truth)


def test_rn16_sic_n_matches_jax(three_tags):
    want, got, truth = three_tags
    _same(got, want, exact=("bits",), amplitude=("h_sync",), margin=("margin",),
          cancel=("cancel",))
    for k, b in enumerate(truth):
        found = {tuple(int(x) for x in r) for r in got.bits[k].numpy()}
        assert {tuple(int(x) for x in t) for t in b} <= found
        assert float(got.cancel[k, -1]) > 0.95


# ---- EPC windows ----------------------------------------------------------------

@pytest.fixture(scope="module")
def epc_windows():
    """A single tag (the residual's CRC must fail), then two same-RN16
    frames at each ratio, aligned (252.5 us) and offset (255 us)."""
    rng = np.random.default_rng(21)
    t1 = _rand_tag(rng, 0x31, 0.09 + 0.02j)
    wins, truth = [_epc_window([(t1, 252.5)])], [(t1, None)]
    for ratio in (0.7, 0.4, 0.15):
        for t1b in (252.5, 255.0):
            rng = np.random.default_rng(22)
            a = _rand_tag(rng, 0x31, 0.09 + 0.02j)
            b = _rand_tag(rng, 0x57, _scaled(0.09 + 0.02j, ratio))
            wins.append(_epc_window([(a, 252.5), (b, t1b)]))
            truth.append((a, b))
    w = np.stack([np.asarray(x) for x in wins])
    want = _jit(ref.epc_sic_batch)(jnp.asarray(w), CFG)
    return w, want, collision.epc_sic_batch(torch.from_numpy(w), port_cfg(CFG)), truth


def test_epc_sic_matches_jax(epc_windows):
    _, want, got, truth = epc_windows
    _same(got, want, exact=("bits", "crc_ok"), amplitude=("h_sync",), cancel=("cancel",))
    assert bool(got.crc_ok[0, 0]) and not bool(got.crc_ok[0, 1])
    assert float(got.cancel[0, 0]) > 0.99
    for k, (a, b) in enumerate(truth[1:], start=1):
        assert bool(got.crc_ok[k].all())
        np.testing.assert_array_equal(got.bits[k, 0].numpy(), a.epc_frame_bits())
        np.testing.assert_array_equal(got.bits[k, 1].numpy(), b.epc_frame_bits())


def test_epc_sic_one_window_is_the_batch_row(epc_windows):
    w, _, batch, _ = epc_windows
    one = collision.epc_sic(torch.from_numpy(w[5]), port_cfg(CFG))
    row = type(batch)(*(v[5] for v in batch))
    _same(one, row, exact=("bits", "crc_ok"), amplitude=("h_sync",), cancel=("cancel",))


# ---- Miller-M and TRext -----------------------------------------------------------

def _miller_windows(cfg, rng):
    """tests/test_collision.py::test_miller_sic_two_tags's windows: one tag,
    then two at T1 offsets 252.5, 255 and 258 us."""
    m = cfg.miller_m
    sp_us = cfg.adc_rate / 1e6

    def window(tags, noise=0.004):
        n = int(round((cfg.t1_us + cfg.t2_us + cfg.rn16_us) * sp_us)) + 8000
        seg = np.full(n, 1.0, dtype=np.complex64)
        for bits, bs, t1 in tags:
            superpose_reply(seg, miller_chips(bits, m), t1, bs, cfg.tag_bit_us / (2 * m),
                            sp_us, cfg.adc_rate)
        x = np.concatenate([np.full(4000, 1.0, np.complex64), seg])
        x = x + (rng.normal(0, noise / 2 ** 0.5, x.size)
                 + 1j * rng.normal(0, noise / 2 ** 0.5, x.size)).astype(np.complex64)
        y = matched_filter_decimate(torch.from_numpy(x), matched_taps(cfg), cfg.decim).numpy()
        dc = y[600:700].mean()
        start = (4000 + int(round(252.5 * sp_us))) // cfg.decim - 8
        return y[start:start + cfg.rn16_window + 8] - dc

    b1, b2 = rng.integers(0, 2, 16), rng.integers(0, 2, 16)
    wins = [window([(b1, BS1, 252.5)])]
    wins += [window([(b1, BS1, 252.5), (b2, 0.045 - 0.035j, t1b)]) for t1b in (252.5, 255.0, 258.0)]
    return wins, b1, b2


@pytest.mark.parametrize("m", sorted(MILLER))
def test_miller_rn16_sic_matches_jax(m):
    cfg = RefConfig(**MILLER[m])
    rng = np.random.default_rng(7)
    for _ in range(5):                   # the reference test's chip-train draws
        rng.integers(0, 2, 16)
    wins, b1, b2 = _miller_windows(cfg, rng)
    _, want, got = _run_rn16(cfg, wins)
    _same(got, want, **RN16_FIELDS)
    assert all(np.array_equal(r.numpy(), b1) for r in got.bits1)
    assert all(np.array_equal(r.numpy(), b2) for r in got.bits2[1:])


def _trext_window(cfg, tags, noise=0.004, seed=3):
    """_window's recipe with TRext=1 replies (pilot tone before the
    preamble) and an RN16 window sized for them."""
    rng = np.random.default_rng(seed)
    sp_us = cfg.adc_rate / 1e6
    n = int(round((cfg.t1_us + cfg.t2_us + cfg.rn16_us) * sp_us)) + 4000
    seg = np.full(n, 1.0, dtype=np.complex64)
    for bits, bs, t1 in tags:
        superpose_reply(seg, fm0_chips(bits, trext=1, pilot_bits=cfg.pilot_tone_bits), t1, bs,
                        cfg.tag_bit_us / 2, sp_us, cfg.adc_rate)
    x = np.concatenate([np.full(2000, 1.0, np.complex64), seg])
    x = x + (rng.normal(0, noise / 2 ** 0.5, x.size)
             + 1j * rng.normal(0, noise / 2 ** 0.5, x.size)).astype(np.complex64)
    y = matched_filter_decimate(torch.from_numpy(x), matched_taps(cfg), cfg.decim).numpy()
    dc = y[300:348].mean()
    start = 400 + int(round(252.5 * sp_us)) // 5 - 4
    return y[start:start + cfg.rn16_window + 8] - dc


def test_fm0_trext_rn16_sic_matches_jax():
    cfg = dataclasses.replace(CFG, trext=1)
    rng = np.random.default_rng(12)
    b1, b2 = rng.integers(0, 2, 16), rng.integers(0, 2, 16)
    wins = [_trext_window(cfg, [(b1, BS1, 252.5)])]
    wins += [_trext_window(cfg, [(b1, BS1, 252.5), (b2, _scaled(BS1, 0.5), t1b)], seed=s)
             for s, t1b in enumerate((252.5, 256.5))]
    _, want, got = _run_rn16(cfg, wins)
    _same(got, want, **RN16_FIELDS)
    assert all(np.array_equal(r.numpy(), b1) for r in got.bits1)
    assert all(np.array_equal(r.numpy(), b2) for r in got.bits2[1:])


# ---- chip trains and template banks ------------------------------------------------

CHIP_CONFIGS = {"fm0": dict(), "fm0_trext": dict(trext=1), "m2": MILLER[2], "m4": MILLER[4],
                "m2_trext": dict(MILLER[2], trext=1)}


@pytest.mark.parametrize("name", sorted(CHIP_CONFIGS))
def test_chip_trains_match(name):
    cfg = RefConfig(**CHIP_CONFIGS[name])
    bits = np.random.default_rng(9).integers(0, 2, (5, 16))
    got = collision.chip_train(torch.from_numpy(bits), port_cfg(cfg)).numpy()
    want = _jit(ref.chip_train)(jnp.asarray(bits[0]), cfg)
    np.testing.assert_array_equal(got[0], np.asarray(want))
    for b, g in zip(bits, got):
        want = (fm0_chips(b, trext=cfg.trext, pilot_bits=cfg.pilot_tone_bits)
                if cfg.miller_m == 1 else miller_chips(b, cfg.miller_m, trext=cfg.trext))
        np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(collision.chip_train(torch.from_numpy(bits[2]), port_cfg(cfg)),
                                  got[2])


@pytest.mark.parametrize("name,n_bits", [("fm0", 16), ("fm0", 128), ("fm0_trext", 16),
                                         ("m2", 16), ("m4", 16), ("m2_trext", 16)])
def test_template_banks_match(name, n_bits):
    cfg = RefConfig(**CHIP_CONFIGS[name])
    got = collision._template_bank(port_cfg(cfg), n_bits)
    want = ref._template_bank(cfg, n_bits)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


# ---- recover_epc_collisions ---------------------------------------------------------

def _same_seed_scene(n_rounds):
    """tests/test_collision.py::test_batch_epc_sic_recovers_second_tags's
    capture: tags 0x41 and 0x77 with one seed draw the same slots and
    RN16s, so every ACK window holds both EPC frames."""
    rng = np.random.default_rng(31)

    def mk(tid, bs):
        epc = rng.integers(0, 2, 96)
        for k in range(8):
            epc[88 + k] = (tid >> (7 - k)) & 1
        return Tag(epc96=epc, seed=5, backscatter=bs)

    tags = [mk(0x41, 0.09 + 0.02j), mk(0x77, 0.04 - 0.035j)]
    return synthesize_inventory(RefConfig(max_events=64), tags, n_rounds=n_rounds, seed=12)


@pytest.fixture(scope="module")
def recovered():
    """The port's decode of the 4-round scene, its recovery, and the JAX
    package's recovery of the same decode (its fields as numpy arrays)."""
    tr = _same_seed_scene(4)
    cfg = port_cfg(RefConfig(max_events=64))
    st, dec = decode_capture(tr.iq, cfg, device="cpu")
    got = recovery.recover_epc_collisions(tr.iq, dec, cfg, device="cpu")
    want = ref_recover(tr.iq, types.SimpleNamespace(**carry.decoded_to_numpy(dec)),
                       RefConfig(max_events=64))
    return tr, st, dec, got, want


def test_recover_epc_collisions_matches_jax(recovered):
    tr, st, _, got, want = recovered
    assert int(st.n_epc_correct) == 4
    assert len(got) == len(want) == 4
    for (e, t, b), (e_ref, t_ref, b_ref) in zip(got, want):
        assert (e, t) == (e_ref, t_ref)
        np.testing.assert_array_equal(b, b_ref)
    assert recovery.extra_tag_reads(got) == {0x77: 4}
    truth = {tuple(int(x) for x in fr)
             for e in tr.events if e.kind == "ack" and e.epc_frames for _, fr in e.epc_frames}
    assert all(tuple(int(x) for x in b) in truth for _, _, b in got)


def test_recover_takes_a_planar_capture(recovered):
    tr, _, dec, got, _ = recovered
    cfg = port_cfg(RefConfig(max_events=64))
    again = recovery.recover_epc_collisions(to_planar(tr.iq), dec, cfg, device="cpu")
    assert [(e, t) for e, t, _ in again] == [(e, t) for e, t, _ in got]
    assert all(np.array_equal(a[2], b[2]) for a, b in zip(again, got))


def test_recover_on_a_single_tag_capture_is_empty():
    """tests/test_collision.py::test_batch_epc_sic_no_false_positives's
    capture: every residual frame fails its CRC."""
    cfg = RefConfig(max_events=64)
    tr = synthesize_inventory(cfg, [Tag.with_id(27, seed=7)], n_rounds=5, seed=3)
    _, dec = decode_capture(tr.iq, port_cfg(cfg), device="cpu")
    assert recovery.recover_epc_collisions(tr.iq, dec, port_cfg(cfg), device="cpu") == []
