"""Comparisons of the port's outputs with the JAX package's, shared by the
``test_torch_*`` files.

Integer and bool outputs must be equal: event tables, decoded bits, CRC
verdicts, tag ids, slot states, command types and every InventoryStats
field.  Float outputs agree within float32 summation-order noise: t_half to
1e-6 (a table entry), h_est and rn16_energy to 1e-4 of their largest
magnitude, the O(1) rn16_margin to 1e-3 absolute, an event's DC to 1e-5 of
the largest |dc| and its CW noise power to rtol 1e-4 (a variance of
differences of ~1e3-magnitude samples).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gen2_rfid_tpu_torch import carry

INT_FIELDS = ("index", "valid", "rn16_fits", "epc_fits", "rn16_bits", "epc_bits",
              "epc_pass", "tag_id", "slot_state", "cmd_type")
# Float field -> (tolerance, relative to the field's largest magnitude?).
FLOAT_TOL = {"t_half": (1e-6, False), "h_est": (1e-4, True),
             "rn16_energy": (1e-4, True), "rn16_margin": (1e-3, False)}

# Decode products read from the RN16 or the EPC window.  A valid event whose
# window runs past the capture's end decodes clamped padding (the reference's
# gather clamps to the last row); the replay never reads those rows, so they
# are compared only where the window fits.
RN16_PRODUCTS = ("rn16_bits", "slot_state", "rn16_energy", "rn16_margin")
EPC_PRODUCTS = ("epc_bits", "epc_pass", "tag_id", "t_half")


def port_cfg(ref_cfg):
    return carry.config_from_fields(dataclasses.asdict(ref_cfg))


def assert_same_decoded(got, want, invalid_rows=True, margin_per_row=False):
    """``invalid_rows=False`` leaves out the decode products of invalid
    events too: their windows are the capture's last granule row repeated,
    where a diversity decode's period search meets candidates whose energy
    sums are equal but for rounding, decided by each side's summation
    order.  ``margin_per_row=True`` holds each rn16_margin above 1 to 1e-3 of
    its own magnitude (the stated tolerance of an O(1) margin, scaled): a
    window that holds no reply has a near-cancelling |h| and a margin of
    tens (ROADMAP.md section 3, item 11)."""
    g = carry.decoded_to_numpy(got)
    np.testing.assert_array_equal(g["valid"], np.asarray(want.valid))
    pad = ~g["valid"] if invalid_rows else np.zeros_like(g["valid"])
    rows = {f: g["rn16_fits"] | pad for f in RN16_PRODUCTS}
    rows.update({f: g["epc_fits"] | pad for f in EPC_PRODUCTS})
    rows["h_est"] = (g["rn16_fits"] & g["epc_fits"]) | pad
    for f in INT_FIELDS:
        keep = rows.get(f, slice(None))
        np.testing.assert_array_equal(g[f][keep], np.asarray(getattr(want, f))[keep],
                                      err_msg=f)
    for f, (tol, relative) in FLOAT_TOL.items():
        keep = rows.get(f, slice(None))
        w = np.asarray(getattr(want, f))[keep]
        scale = max(np.abs(w).max(initial=0.0), 1e-30) if relative else 1.0
        got_f = g[f][keep]
        if margin_per_row and f == "rn16_margin":
            row = np.maximum(np.abs(w), 1.0)
            got_f, w = got_f / row, w / row
        np.testing.assert_allclose(got_f, w, rtol=0, atol=tol * scale, err_msg=f)


def assert_same_stats(got, want):
    g = carry.stats_to_numpy(got)
    for f in got._fields:
        np.testing.assert_array_equal(g[f], np.asarray(getattr(want, f)), err_msg=f)


def assert_same_events(got, want):
    """Gate event tables: integer fields equal, DC and noise power close."""
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.n_events) == int(want.n_events)
    np.testing.assert_array_equal(got.n_pulses.numpy(), np.asarray(want.n_pulses))
    v = got.valid.numpy()
    dc_want = np.asarray(want.dc)[v]
    np.testing.assert_allclose(got.dc.numpy()[v], dc_want, rtol=0,
                               atol=1e-5 * np.abs(dc_want).max(initial=0.0))
    np.testing.assert_allclose(got.noise_var.numpy()[v],
                               np.asarray(want.noise_var)[v], rtol=1e-4)


def replay_table(rows, cfg, capacity=None):
    """A well-formed decoded table for the replay, as a dict of numpy arrays
    under DecodedEvents' fields: each of the (at least one) ``rows`` is None
    for a QueryRep (an RN16 window, slot single) or ``(tag_id, crc_ok)``
    for an ACK (an EPC window), each event a window after the last, every
    window fitting; invalid rows pad the table to ``capacity``."""
    from gen2_rfid_tpu_torch.runtime.inventory import CMD_ACK, CMD_QREP

    e = len(rows)
    pad = (capacity or e) - e
    acks = [r for r in rows if r is not None]
    ack = np.array([r is not None for r in rows] + [False] * pad)
    valid = np.array([True] * e + [False] * pad)
    window = np.where(ack, cfg.epc_window, cfg.rn16_window) + 3
    index = 100 + np.concatenate([[0], np.cumsum(window[:-1])])
    index[e:] = index[e - 1] + window[e - 1]
    tag, ok = np.zeros(e + pad, np.int32), np.zeros(e + pad, bool)
    tag[ack], ok[ack] = [t for t, _ in acks], [c for _, c in acks]
    n = e + pad
    return {
        "index": index.astype(np.int32), "valid": valid, "rn16_fits": valid.copy(),
        "epc_fits": valid.copy(), "rn16_bits": np.zeros((n, 16), np.int32),
        "epc_bits": np.zeros((n, 128), np.int32), "epc_pass": ok,
        "tag_id": tag, "t_half": np.ones(n, np.float32),
        "h_est": np.zeros((n, 2), np.float32),
        "slot_state": (valid & ~ack).astype(np.int32),
        "rn16_energy": np.zeros(n, np.float32), "rn16_margin": np.zeros(n, np.float32),
        "cmd_type": np.where(ack, CMD_ACK, CMD_QREP).astype(np.int32),
    }


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module that imports this fixture: its
    port ops are small, and beside the JAX CPU client's threads and the
    other test workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_reader_wideband(n_rounds=2):
    """A 4 Msps capture of two readers for ``decode --wideband 2``: tag 99
    on channel 0 (DC) and tag 27 on channel 1 (-2 MHz), each an inventory
    of ``n_rounds`` rounds synthesized at 4 Msps, as tests/test_channelizer.py
    builds its 16 Msps scene.  Returns (complex64 capture, {channel: tag})."""
    import numpy as np

    from gen2_rfid_tpu_torch.config import ReaderConfig
    from gen2_rfid_tpu_torch.sim.tag import Tag
    from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory

    synth = ReaderConfig(adc_rate=4e6)
    tr_a = synthesize_inventory(synth, [Tag.with_id(99, seed=9)], n_rounds=n_rounds, seed=4,
                                noise=0.0)
    tr_b = synthesize_inventory(synth, [Tag.with_id(27, seed=7)], n_rounds=n_rounds, seed=3,
                                noise=0.0)
    n = max(tr_a.iq.size, tr_b.iq.size)
    wide = np.zeros(n, np.complex64)
    wide[: tr_a.iq.size] += tr_a.iq
    sign = np.where(np.arange(tr_b.iq.size) % 2 == 0, 1, -1).astype(np.complex64)
    wide[: tr_b.iq.size] += tr_b.iq * sign          # shifted by half the rate
    rng = np.random.default_rng(5)
    wide += (rng.normal(0, 0.002, n) + 1j * rng.normal(0, 0.002, n)).astype(np.complex64)
    return wide, {0: 99, 1: 27}
