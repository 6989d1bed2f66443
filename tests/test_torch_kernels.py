"""The port's kernels: plain versions against the Pallas kernels, and the
CUDA kernels against their plain versions.

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX package's Pallas kernels in interpret mode (as
tests/test_kernels.py runs them) and against its XLA oracles.  The CUDA
kernels themselves build and run only on a GPU: tests/test_torch_cuda.py
and ``chip_smoke.py`` hold them against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp.filters import (
    boxcar_taps as ref_boxcar_taps,
    matched_filter_decimate as ref_mfd,
    moving_sum,
    moving_sum_complex,
)
from gen2_rfid_tpu.kernels.gate_front import gate_front as ref_gate_front
from gen2_rfid_tpu.kernels.gate_stack import (
    gate_stack_flags as ref_gate_stack_flags,
    native_flags_reference,
)
from gen2_rfid_tpu.sim.trace import golden_trace as ref_golden_trace
from gen2_rfid_tpu_torch import kernels
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp.gate import gate_detect
from gen2_rfid_tpu_torch.kernels import _build
from gen2_rfid_tpu_torch.kernels.compat_gate import compat_gate_for_cfg
from gen2_rfid_tpu_torch.kernels.gate_front import (
    gate_front,
    gate_front_for_cfg,
    gate_front_plain,
)
from gen2_rfid_tpu_torch.kernels.gate_pulses import gate_pulses
from gen2_rfid_tpu_torch.kernels.gate_scan import gate_scan_for_cfg
from gen2_rfid_tpu_torch.kernels.gate_stack import (
    gate_stack_flags,
    gate_stack_for_cfg,
    gate_stack_plain,
)
from gen2_rfid_tpu_torch.kernels.probe import probe

CFG = ReaderConfig()
STACK_ARGS = (CFG.win_length, CFG.n_samples_pw // 2, CFG.n_samples_t1,
              CFG.thresh_fraction)


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, n)).astype(np.float32)


@pytest.fixture(scope="module")
def golden_y2():
    """Planar post-decimation y of the golden trace, from the port's front end."""
    tr = ref_golden_trace(RefConfig())
    x2 = torch.from_numpy(np.stack([tr.iq.real, tr.iq.imag]).astype(np.float32))
    return gate_front_for_cfg(x2, CFG)[0]


# ---- gate_front ---------------------------------------------------------

@pytest.mark.parametrize("n,block_y", [(40961, 2048), (9999, 512), (2048 * 5, 2048)])
def test_gate_front_plain_matches_pallas(n, block_y):
    """Same summation order as the Pallas kernel: y and the windowed sums
    agree to the bit; amp within test_kernels.py's atol (XLA's CPU sqrt of
    a*a+b*b is not correctly rounded, the port's is)."""
    x2 = _noise(n, n)
    want = ref_gate_front(jnp.asarray(x2), 5, 25, 100, 48, block_y=block_y,
                          interpret=True)
    got = gate_front_plain(torch.from_numpy(x2), 5, 25, 100, 48)
    y2, amp, avg, dc2 = (t.numpy() for t in got)
    np.testing.assert_array_equal(y2, np.asarray(want[0]))
    np.testing.assert_allclose(amp, np.asarray(want[1]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(avg, np.asarray(want[2]), rtol=2e-5, atol=0)
    np.testing.assert_array_equal(dc2, np.asarray(want[3]))


@pytest.mark.parametrize("n", [40961, 9999, 10240])
def test_gate_front_plain_matches_xla_front(n):
    """Against the default XLA path (strided conv + blocked-cumsum moving
    sums), with test_kernels.py's tolerances."""
    x2 = _noise(n, n + 1)
    y2, amp, avg, dc2 = (t.numpy() for t in gate_front_plain(
        torch.from_numpy(x2), 5, 25, 100, 48))
    y_ref = ref_mfd(jnp.asarray(x2[0] + 1j * x2[1]), ref_boxcar_taps(25), 5)
    np.testing.assert_allclose(y2[0], np.real(y_ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(y2[1], np.imag(y_ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(amp, np.abs(np.asarray(y_ref)), rtol=0, atol=2e-5)
    np.testing.assert_allclose(avg, np.asarray(moving_sum(jnp.abs(y_ref), 100)),
                               rtol=2e-5, atol=1e-2)
    dc_ref = np.asarray(moving_sum_complex(y_ref, 48))
    np.testing.assert_allclose(dc2[0], dc_ref.real, rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(dc2[1], dc_ref.imag, rtol=2e-5, atol=1e-2)


@pytest.mark.parametrize("n", [0, 3, 7, 24, 26, 499])
def test_gate_front_tiny_and_ragged(n):
    """Fewer samples than a tap span, a decimation step or a window: the
    zero history still gives N // decim outputs equal to a direct sum."""
    x2 = _noise(n, 3)
    y2, amp, avg, dc2 = gate_front(torch.from_numpy(x2), 5, 25, 100, 48)
    ny = n // 5
    assert y2.shape == (2, ny) and amp.shape == (ny,) and dc2.shape == (2, ny)
    xp = np.concatenate([np.zeros((2, 24), np.float32), x2], axis=1)
    for k in range(ny):
        want = xp[:, 5 * k: 5 * k + 25].astype(np.float64).sum(axis=1)
        np.testing.assert_allclose(y2[:, k].numpy(), want, rtol=1e-5, atol=1e-5)
    if ny:
        np.testing.assert_allclose(avg.numpy(), np.cumsum(amp.numpy()), rtol=1e-5)


def test_gate_front_for_cfg_shapes():
    y2, amp, avg, dc2 = gate_front_for_cfg(torch.zeros((2, 50000)), CFG)
    assert y2.shape == (2, 10000) and amp.shape == (10000,)
    assert avg.shape == (10000,) and dc2.shape == (2, 10000)


# ---- gate_stack ---------------------------------------------------------

def test_gate_stack_plain_matches_oracle_on_golden(golden_y2):
    y2 = golden_y2.numpy()
    got = gate_stack_for_cfg(golden_y2, CFG).numpy()
    oracle = native_flags_reference(jnp.asarray(y2[0] + 1j * y2[1]), RefConfig())
    np.testing.assert_array_equal(got, np.asarray(oracle))
    assert (got & 1).sum() > 1000 and (got & 8).sum() > 1000


@pytest.mark.parametrize("block", [8192, 2048])
def test_gate_stack_plain_matches_pallas_on_golden(golden_y2, block):
    """Equal to the Pallas kernel except where the Pallas kernel is short of
    lookback: its left halo is max(win, 128) = 128 samples, but a marker at
    a block's first samples needs win-1 + nt1 = 195 (the nt1+1 `above`
    samples, each with a win-sample average).  There its truncated average
    can only lower the threshold and add marker bits; nothing else differs.
    The port stages the full lookback and equals native_flags_reference."""
    y2 = golden_y2.numpy()
    got = gate_stack_for_cfg(golden_y2, CFG).numpy()
    pallas = np.asarray(ref_gate_stack_flags(jnp.asarray(y2), *STACK_ARGS,
                                             block=block, interpret=True))
    diff = np.nonzero(got != pallas)[0]
    assert np.all(diff % block <= CFG.n_samples_t1), diff
    np.testing.assert_array_equal(pallas[diff] ^ got[diff], 4)   # marker only
    assert np.all(pallas[diff] & 4)
    assert diff.size <= 4


@pytest.mark.parametrize("n,block", [(9999, 2048), (40961, 8192)])
def test_gate_stack_plain_matches_pallas_and_oracle_on_noise(n, block):
    y2 = _noise(n, 4 + n)
    got = gate_stack_flags(torch.from_numpy(y2), *STACK_ARGS).numpy()
    pallas = ref_gate_stack_flags(jnp.asarray(y2), *STACK_ARGS, block=block,
                                  interpret=True)
    oracle = native_flags_reference(jnp.asarray(y2[0] + 1j * y2[1]), RefConfig())
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(oracle))


@pytest.mark.parametrize("n", [0, 1, 50, 97, 98, 300])
def test_gate_stack_short_inputs(n):
    """Shorter than the average window or the T1 run: quiet is False where
    its look-ahead leaves the capture, and nothing reads past the end."""
    y2 = _noise(n, 8)
    got = gate_stack_flags(torch.from_numpy(y2), *STACK_ARGS)
    assert got.shape == (n,) and got.dtype == torch.int32
    nt1 = CFG.n_samples_t1
    assert not ((got[max(n - nt1 - 1, 0):] & 8) != 0).any()
    if n > nt1:   # the oracle's shifted concat needs n > nt1
        oracle = native_flags_reference(jnp.asarray(y2[0] + 1j * y2[1]), RefConfig())
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


# ---- wrappers -----------------------------------------------------------

def test_cpu_tensors_count_no_launches(golden_y2):
    kernels.reset_launches()
    gate_front(torch.zeros((2, 1000)), 5, 25, 100, 48)
    gate_stack_flags(golden_y2[:, :5000].contiguous(), *STACK_ARGS)
    amp = torch.ones(1000)
    gate_scan_for_cfg(amp, amp, CFG)
    compat_gate_for_cfg(amp, amp, CFG)
    probe(torch.zeros((8, 128)))
    gate_detect(torch.complex(golden_y2[0, :5000], golden_y2[1, :5000]), CFG)
    assert kernels.launches == {"gate_front": 0, "gate_stack": 0, "gate_scan": 0,
                                "compat_gate": 0, "probe": 0, "gate_pulses": 0}


def test_keeping_inputs_on_the_cpu_keeps_and_counts_nothing(golden_y2):
    """CPU tensors take the plain versions: no body counted, no input kept;
    ``keep`` itself keeps one copy a key, and only while on."""
    kernels.reset_launches()
    kernels.keep_inputs(True)
    try:
        gate_front(torch.zeros((2, 1000)), 5, 25, 100, 48)
        gate_stack_flags(golden_y2[:, :5000].contiguous(), *STACK_ARGS)
        assert kernels.kept == {} and kernels.stack_bodies == {"stream": 0, "segment": 0}
        x = torch.arange(6.0).reshape(2, 3)
        kernels.keep("k", x, (1,))
        kernels.keep("k", torch.zeros(2, 3), (1,))
        kernels.keep("k", x, (2,))
        x += 1
    finally:
        kernels.keep_inputs(False)
    kernels.keep("k", x, (3,))
    assert list(kernels.kept) == [("k", (2, 3), 1), ("k", (2, 3), 2)]
    assert torch.equal(kernels.kept[("k", (2, 3), 1)], torch.arange(6.0).reshape(2, 3))
    kernels.stack_bodies["stream"] = 5
    kernels.reset_launches()
    assert kernels.stack_bodies == {"stream": 0, "segment": 0}


def test_wrappers_reject_other_devices_and_shapes():
    meta = torch.empty((2, 100), device="meta")
    with pytest.raises(ValueError):
        gate_front(meta, 5, 25, 100, 48)
    with pytest.raises(ValueError):
        gate_stack_flags(meta, *STACK_ARGS)
    with pytest.raises(ValueError):
        gate_front(torch.zeros(100), 5, 25, 100, 48)
    with pytest.raises(ValueError):
        gate_stack_flags(torch.zeros((3, 100)), *STACK_ARGS)
    with pytest.raises(ValueError):
        gate_scan_for_cfg(meta[0], meta[0], CFG)
    with pytest.raises(ValueError):
        gate_scan_for_cfg(torch.zeros(100), torch.zeros(99), CFG)
    with pytest.raises(ValueError):
        probe(meta)
    flags = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="gate_pulses_plain"):
        gate_pulses(flags, 96, 5, 64, 1024)
    with pytest.raises(ValueError):
        gate_pulses(meta[0].to(torch.int32), 96, 5, 64, 1024)
    with pytest.raises(ValueError):
        gate_pulses(flags.reshape(10, 10), 96, 5, 64, 1024)


def test_build_flags_keep_ieee_rounding():
    flags = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert set(_build.SOURCES) == set(kernels.launches)
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path == _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and name in path.name


@pytest.mark.parametrize("code", [0, 700])
def test_launch_raises_a_cuda_error_and_counts_a_launch(monkeypatch, code):
    """``_build.launch`` calls the entry point with its arguments and the
    device's current stream; a non-zero code raises naming the kernel and
    counts nothing, a zero code counts one launch."""
    import contextlib
    import types

    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1234))
    calls = []

    def entry(*args):
        calls.append(args)
        return code

    before = dict(kernels.launches)
    if code:
        with pytest.raises(RuntimeError, match="^probe kernel launch failed: CUDA error 700$"):
            _build.launch("probe", entry, torch.device("cuda"), 7, 8)
    else:
        _build.launch("probe", entry, torch.device("cuda"), 7, 8)
    assert calls == [(7, 8, 1234)]
    assert kernels.launches == {**before, "probe": before["probe"] + (code == 0)}
