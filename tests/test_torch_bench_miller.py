"""The Miller cases of the configuration matrix (``tools/bench_configs.py``'s
twin: ``miller4``, ``miller2``, ``miller8_trext``), narrowed to 3 rounds
tiled twice, against the JAX package on the CPU: the capture bit for bit,
the twin's case body's InventoryStats equal to the JAX decode's in every
field.  Split from ``test_torch_bench_decode.py``: each Miller JAX decode
compiles for 7-20 s.
"""

import pytest

from bench_compare import check_case_decode
from torch_compare import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["miller4", "miller2", "miller8_trext"])
def test_miller_case_decode_matches_jax(monkeypatch, name):
    check_case_decode(monkeypatch, name)
