"""The execution probe: ``x * 2 + 1`` elementwise on float32.

Port of the Pallas TPU kernel in ``tools/tpu_gate_sums_experiment.py``
(``run``, body ``k``), which the JAX tool launches on an (8, 128) tile to
check that a hand-written kernel executes on the device.  On a CUDA tensor
the wrapper launches ``csrc/probe.cu``; on a CPU tensor it runs
``probe_plain``.  Both round ``x * 2`` (exact) and ``+ 1`` once, so they
agree bit for bit.
"""

from __future__ import annotations

import torch

from ._build import I32, I64, PTR, Library, launch

LIB = Library("probe", {"probe_launch": (I32, (PTR, I64, PTR, PTR))})


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return x * 2.0 + 1.0


def probe(x: torch.Tensor) -> torch.Tensor:
    """float32 tensor of any shape -> ``x * 2 + 1`` of the same shape."""
    if x.device.type == "cpu":
        return probe_plain(x.to(torch.float32))
    if x.device.type != "cuda":
        raise ValueError(f"probe runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise ValueError("probe takes a float32 tensor")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    launch("probe", LIB.probe_launch, x.device, x.data_ptr(), x.numel(), out.data_ptr())
    return out
