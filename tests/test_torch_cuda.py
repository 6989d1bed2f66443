"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built at first
use) and skip without one.  The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX).
"""

import numpy as np
import pytest
import torch

from gen2_rfid_tpu_torch import kernels
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front, gate_front_plain
from gen2_rfid_tpu_torch.kernels.gate_scan import (
    gate_scan, gate_scan_for_cfg, gate_scan_plain, pulse_train)
from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_flags, gate_stack_plain
from gen2_rfid_tpu_torch.kernels.probe import probe, probe_plain

CFG = ReaderConfig()
STACK_ARGS = (CFG.win_length, CFG.n_samples_pw // 2, CFG.n_samples_t1,
              CFG.thresh_fraction)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card; the tests skip on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _noise(n, seed):
    return np.random.default_rng(seed).normal(size=(2, n)).astype(np.float32)


@pytest.mark.parametrize("n,block_y", [(40961, 512), (9999, 64), (10240, 2048), (7, 512)])
def test_gate_front_kernel_matches_plain(cuda, n, block_y):
    x2 = torch.from_numpy(_noise(n, n)).to(cuda)
    before = kernels.launches["gate_front"]
    got = gate_front(x2, 5, 25, 100, 48, block_y=block_y)
    want = gate_front_plain(x2, 5, 25, 100, 48)
    torch.cuda.synchronize()
    assert kernels.launches["gate_front"] == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("n,block", [(40961, 1024), (9999, 256), (10240, 4096), (150, 1024)])
def test_gate_stack_kernel_matches_plain(cuda, n, block):
    y2 = torch.from_numpy(_noise(n, n)).to(cuda)
    before = kernels.launches["gate_stack"]
    got = gate_stack_flags(y2, *STACK_ARGS, block=block)
    want = gate_stack_plain(y2, *STACK_ARGS)
    torch.cuda.synchronize()
    assert kernels.launches["gate_stack"] == before + 1
    assert torch.equal(got, want)


def _amp_avg(n, seed):
    """|y| of noise around a CW level and its 100-sample average."""
    y2 = torch.from_numpy(_noise(n, seed) * 0.3 + np.array([[1.0], [0.5]], np.float32))
    amp = torch.sqrt(y2[0] ** 2 + y2[1] ** 2)
    avg = torch.nn.functional.avg_pool1d(
        torch.nn.functional.pad(amp[None, None], (99, 0)), 100, 1)[0, 0]
    return amp, avg


@pytest.mark.parametrize("n", [40961, 9999, 4096, 4097, 1])
def test_gate_scan_kernel_matches_plain(cuda, n):
    amp, avg = _amp_avg(n, n)
    # Ties: a stretch where amp equals its threshold exactly.
    avg[: min(n, 50)] = amp[: min(n, 50)] / CFG.thresh_fraction
    before = kernels.launches["gate_scan"]
    trig, pulses = gate_scan_for_cfg(amp.to(cuda), avg.to(cuda), CFG)
    torch.cuda.synchronize()
    assert kernels.launches["gate_scan"] == before + 1
    want_trig, want_pulses = gate_scan_for_cfg(amp, avg, CFG)
    assert torch.equal(trig.cpu(), want_trig)
    assert torch.equal(pulses.cpu(), want_pulses)


@pytest.mark.parametrize("n,rn16w,epcw", [(40961, 1, 1), (40961, 1, 37), (20481, 40, 4100),
                                          (12289, 33, 64), (4097, 5, 3), (4096, 1, 1)])
def test_gate_scan_kernel_on_pulse_trains(cuda, n, rn16w, epcw):
    """Triggers on word and chunk ends and on the last sample, open windows
    across chunk edges, windows of one sample, and ties."""
    args = (0.5, 2, 5, 3, rn16w, epcw)
    amp, avg, targets = pulse_train(n, 2, 5, 3, rn16w, epcw, seed=n)
    before = kernels.launches["gate_scan"]
    trig, pulses = gate_scan(amp.to(cuda), avg.to(cuda), *args)
    torch.cuda.synchronize()
    assert kernels.launches["gate_scan"] == before + 1
    want_trig, want_pulses = gate_scan_plain(amp, avg, *args)
    assert trig.cpu().nonzero().flatten().tolist() == targets
    assert torch.equal(trig.cpu(), want_trig)
    assert torch.equal(pulses.cpu(), want_pulses)


def test_gate_scan_kernel_on_golden(cuda):
    """142 triggers, open windows across chunk boundaries."""
    from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
    from gen2_rfid_tpu_torch.runtime.inventory import to_planar
    from gen2_rfid_tpu_torch.sim.trace import golden_trace

    _, amp, avgsum, _ = gate_front_for_cfg(to_planar(golden_trace(CFG).iq), CFG)
    avg = avgsum / torch.tensor(float(CFG.win_length))
    trig, pulses = gate_scan_for_cfg(amp.to(cuda), avg.to(cuda), CFG)
    want_trig, want_pulses = gate_scan_for_cfg(amp, avg, CFG)
    assert int(want_trig.sum()) == 142
    assert torch.equal(trig.cpu(), want_trig)
    assert torch.equal(pulses.cpu(), want_pulses)


@pytest.mark.parametrize("shape", [(8, 128), (1,), (3, 7), (1 << 20,)])
def test_probe_kernel_matches_plain(cuda, shape):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(cuda)
    before = kernels.launches["probe"]
    got = probe(x)
    torch.cuda.synchronize()
    assert kernels.launches["probe"] == before + 1
    assert torch.equal(got, probe_plain(x))
    assert torch.equal(probe(x[..., 1:]), probe_plain(x[..., 1:]))   # unaligned view
