"""Compat mode and the exact gate at BLF 640 kHz (8 Msps, decim 2) and
160 kHz (Tari 24 us, DR 64/3, 2 Msps, decim 1), whole decodes of the port
against the JAX package's on the CPU (tests/geometry_compare.py).

Compat reads no EPC at either BLF, in both packages: it keeps the
reference's 2 tag bits of window slack and its sync search of 1.5 tag
bits, too short for a reply that starts a fixed turnaround after the gate
opens once tag bits are short (ROADMAP.md section 3, item 11).  The exact
gate in native mode reads every EPC.
"""

import pytest

from geometry_compare import DECODES, assert_decode_equals_jax, port_decode, ref_config
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("name", ["blf640", "blf160"])
@pytest.mark.parametrize("label", list(DECODES))
def test_blf_decode_equals_jax(name, label):
    """In compat mode no window holds a reply, so rn16_margin (mean
    |Re(d h*)| / |h|^2 over a near-cancelling h) reads tens, not 1: it is
    held to 1e-3 of its own size (item 11: at BLF 640 kHz the port and JAX
    differ by up to 9.3e-4 of it, 0.052 of 55.737)."""
    stats = assert_decode_equals_jax(name, label,
                                     margin_per_row=DECODES[label][0] == "compat")
    assert int(stats.n_queries) == 3


@pytest.mark.parametrize("name", ["blf640", "blf160"])
def test_compat_windows_hold_no_reply(name):
    """Every compat channel estimate is under a fifth of the smallest one
    the exact native decode reads off a reply on the same capture, and no
    compat window passes its CRC."""
    _, dec = port_decode(name, "compat")
    _, ref = port_decode(name, "exact_native")
    h = dec.h_est[dec.valid].norm(dim=1)
    h_reply = ref.h_est[ref.valid].norm(dim=1)
    assert bool((h < 0.2 * h_reply.min()).all())
    assert not bool(dec.epc_pass.any())


@pytest.mark.parametrize("name", ["blf640", "blf160"])
def test_compat_windows_are_shorter_than_native(name):
    """What item 11 rests on: compat's window slack and sync search are
    the reference's fixed tag-bit counts, native's cover 36 us of jitter."""
    compat, native = ref_config(name, "compat"), ref_config(name, "exact_native")
    assert compat.window_slack == 2 * compat.n_samples_tag_bit_i < native.window_slack
    assert compat.sync_search == int(1.5 * compat.n_samples_tag_bit) < native.sync_search
