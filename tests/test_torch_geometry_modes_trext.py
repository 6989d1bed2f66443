"""Compat mode at bench_configs.py's Miller-8 TRext geometry (8 Msps,
decim 2), whole decodes of the port against the JAX package's on the CPU,
without and with the exact gate (tests/geometry_compare.py).  The exact
gate in native mode there is tests/test_torch_miller_decode.py's
``test_exact_gate_miller_equals_jax``."""

import pytest

from geometry_compare import assert_decode_equals_jax
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("label", ["compat", "exact_compat"])
def test_miller8_trext_decode_equals_jax(label):
    assert_decode_equals_jax("miller8_trext", label)
