"""The gate-sums tool's formulations and the probe's plain version, on the CPU.

The convolution sums the same windows as ``run_sum`` in another float32
order: within 1e-5 relative of the window sum (at most 100 terms near 1).
The blocked pulse count is exact integer arithmetic and must equal the
segmented doubling scan where a reset falls in every span.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gen2_rfid_tpu.dsp.filters import run_sum as ref_run_sum
from gen2_rfid_tpu.dsp.gate import _rises_since_reset as ref_rises
from gen2_rfid_tpu_torch import kernels
from gen2_rfid_tpu_torch.dsp.filters import run_sum
from gen2_rfid_tpu_torch.dsp.gate import _rises_since_reset
from gen2_rfid_tpu_torch.kernels.probe import probe, probe_plain
from gen2_rfid_tpu_torch.tools import gate_sums_experiment as tool


@pytest.mark.parametrize("n,block", [(30000, 8192), (4099, 512), (100, 128)])
def test_conv_sums_match_dyadic(n, block):
    amp = tool.amplitudes(n)
    s = tool.conv_sums(torch.from_numpy(amp), tool.WINS, block)
    assert s.shape == (len(tool.WINS), n)
    for c, w in enumerate(tool.WINS):
        want = np.asarray(ref_run_sum(jnp.asarray(amp), w))
        np.testing.assert_allclose(s[c].numpy(), want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(s[c].numpy(), run_sum(torch.from_numpy(amp), w).numpy(),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,block", [(40000, 8192), (9000, 2048)])
def test_blocked_rises_equal_doubling_scan(n, block):
    rise, reset = tool.rises_and_resets(n)
    reset[:: tool.SPAN // 2] = True
    got = tool.rises_blocked(torch.from_numpy(rise), torch.from_numpy(reset),
                             tool.SPAN, block)
    want = _rises_since_reset(torch.from_numpy(rise), torch.from_numpy(reset), tool.SPAN)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_rises(jnp.asarray(rise), jnp.asarray(reset),
                                          tool.SPAN)).astype(np.int32))


def test_probe_plain_and_cpu_wrapper():
    x = torch.from_numpy(tool.amplitudes(8 * 128).reshape(8, 128))
    want = x.numpy() * np.float32(2) + np.float32(1)
    np.testing.assert_array_equal(probe_plain(x).numpy(), want)
    kernels.reset_launches()
    np.testing.assert_array_equal(probe(x).numpy(), want)
    assert kernels.launches["probe"] == 0


def test_tool_run_refuses_tf32(monkeypatch):
    """TF32 is the entry point's policy: run() checks it and sets nothing."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tool.run()
    assert torch.backends.cudnn.allow_tf32


def test_tool_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 2
    assert "needs a CUDA device" in capsys.readouterr().err
