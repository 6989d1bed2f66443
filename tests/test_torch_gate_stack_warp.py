"""The gate-stack kernel's warp stream, modelled on the CPU.

``kernels/gate_stack.py::gate_stack_warp_plain`` runs the CUDA kernel's
decomposition in PyTorch: lane-strided steps with a shift and carry per
dyadic level, the ballot words and the word-level flag rules, and runs of
words with their halos and carried state.  Its flags must equal
``gate_stack_plain``'s and the JAX oracle's
(``gen2_rfid_tpu/kernels/gate_stack.py::native_flags_reference``) exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.kernels.gate_stack import native_flags_reference
from gen2_rfid_tpu.sim.trace import golden_trace
from gen2_rfid_tpu_torch.kernels import gate_stack as gs
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from torch_compare import port_cfg

# The reference configuration of each geometry the cases use.
REF_CFGS = {
    gs.READER: RefConfig(),
    gs.READER[:3] + (1.0,): RefConfig(thresh_fraction=1.0),
    gs.BLF640: RefConfig(blf_hz=640e3, adc_rate=8e6, decim=2),
    gs.BLF160: RefConfig.for_link(blf_hz=160e3, tari_us=24.0, dr=1, adc_rate=2e6, decim=1),
}
CASES = gs.stream_cases()


def _oracle(y2, geo):
    cfg = REF_CFGS[geo]
    assert (cfg.win_length, cfg.n_samples_pw // 2, cfg.n_samples_t1,
            cfg.thresh_fraction) == geo
    y = y2.numpy()
    return np.asarray(native_flags_reference(jnp.asarray(y[0] + 1j * y[1]), cfg))


@pytest.fixture(scope="module")
def golden_y2():
    tr = golden_trace(RefConfig())
    return gate_front_for_cfg(inv.to_planar(tr.iq), port_cfg(RefConfig()))[0]


@pytest.mark.parametrize("run", [29, 7, 1])
def test_model_matches_plain_and_oracle_on_golden(golden_y2, run):
    got = gs.gate_stack_warp_plain(golden_y2, *gs.READER, run=run)
    assert torch.equal(got, gs.gate_stack_plain(golden_y2, *gs.READER))
    np.testing.assert_array_equal(got.numpy(), _oracle(golden_y2, gs.READER))
    assert all(int((got >> b & 1).sum()) > 100 for b in range(4))


@pytest.mark.parametrize("label,y2,geo,run", CASES, ids=[c[0] for c in CASES])
def test_model_matches_plain_and_oracle(label, y2, geo, run):
    got = gs.gate_stack_warp_plain(y2, *geo, run=run)
    want = gs.gate_stack_plain(y2, *geo)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert torch.equal(got, want), (got != want).nonzero().flatten()[:10]
    if y2.shape[1] > geo[2]:   # the oracle's shifted concat needs n > nt1
        np.testing.assert_array_equal(got.numpy(), _oracle(y2, geo))


def test_cases_set_every_flag():
    """The bursts set every bit under each geometry; the ties, all-above
    and all-below captures give the runs they are named for."""
    by_label = {c[0]: c for c in CASES}
    for label in ("bursts n=20000 run=29", "blf640 bursts n=30001 run=29",
                  "blf160 bursts n=30001 run=29"):
        _, y2, geo, _ = by_label[label]
        flags = gs.gate_stack_plain(y2, *geo)
        assert all(int((flags >> b & 1).sum()) > 0 for b in range(4)), label
    _, y2, geo, _ = by_label["ties n=3000"]
    flags = gs.gate_stack_plain(y2, *geo)
    assert int(flags[0]) & gs.RISE and not bool(flags[99:].any())
    _, y2, geo, _ = by_label["all above n=3000"]
    flags = gs.gate_stack_plain(y2, *geo)
    assert bool((flags[96:-97] == gs.MARKER | gs.QUIET).all())
    _, y2, geo, _ = by_label["all below n=3000"]
    assert not bool(gs.gate_stack_plain(y2, *geo).any())


def test_geometry_of_the_stream():
    """ReaderConfig's widths: 7 words before a run (4 until the 100-sample
    sum is exact, 3 of marker lookback) and quiet 4 steps behind, shifted by
    3 words and 1 bit."""
    assert gs.stream_geometry(*gs.READER[:3]) == (7, 4, 3, 1)
    assert gs.stream_geometry(*gs.BLF640[:3]) == (32 + 30, 31, 30, 1)
    assert gs.stream_geometry(1, 0, 0) == (1, 1, 0, 1)


def test_carry_shift_is_a_shift_of_the_flat_stream():
    """Shifting the (warps, steps, 32) layout with its carries equals
    shifting each warp's flat sample stream, zero-filled."""
    x = torch.arange(2 * 5 * 32, dtype=torch.float32).reshape(2, 5, 32) + 1
    for s in (0, 1, 5, 31, 32, 33, 64, 100, 160, 200):
        flat = x.reshape(2, -1)
        want = torch.cat([torch.zeros(2, min(s, 160)), flat[:, :max(160 - s, 0)]], 1)
        assert torch.equal(gs._carry_shift(x, s).reshape(2, -1), want), s


def test_model_rejects_what_the_stream_cannot_take():
    y2 = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="warp stream"):
        gs.gate_stack_warp_plain(y2, 100, 32, 96, 0.75)
    with pytest.raises(ValueError, match="warp stream"):
        gs.gate_stack_warp_plain(y2, *gs.READER, run=0)
    assert gs.gate_stack_warp_plain(torch.zeros(2, 0), *gs.READER).shape == (0,)
