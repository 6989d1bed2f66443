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
from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_flags, gate_stack_plain

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
