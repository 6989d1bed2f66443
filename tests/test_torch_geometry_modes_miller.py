"""Compat mode and the exact gate at bench_configs.py's Miller-4 geometry
(decim 1, 2 Msps), whole decodes of the port against the JAX package's on
the CPU: stats and integer decode fields equal, floats as
tests/torch_compare.py states (tests/geometry_compare.py)."""

import pytest

from geometry_compare import DECODES, assert_decode_equals_jax
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("label", list(DECODES))
def test_miller4_decode_equals_jax(label):
    assert_decode_equals_jax("miller4", label)


def test_geometries_are_chip_smokes():
    """The geometries held here are chip_smoke.py's phase 16b's (its
    full-size captures: tag 27 seed 7 at simulator seed 2, each cell's
    tiles), with the 32-row table of its 3-round captures."""
    import dataclasses

    import chip_smoke
    from gen2_rfid_tpu_torch.tools.bench_configs import TAG27
    from geometry_compare import GEOMETRIES
    from torch_compare import port_cfg

    cases = chip_smoke.geometry_cases()
    assert list(cases) == list(GEOMETRIES) == list(chip_smoke.GEOMETRY_EPCS)
    for name, case in cases.items():
        assert dataclasses.replace(case.cfg, max_events=chip_smoke.SMALL_EVENTS) == \
            port_cfg(GEOMETRIES[name])
        assert (case.tags, case.seed) == (TAG27, 2)
    assert [(n, c.n_rounds, c.tiles) for n, c in cases.items()] == [
        ("miller4", 20, 24), ("miller2", 20, 20), ("miller8_trext", 20, 6), ("blf640", 20, 13),
        ("blf160", 20, 20), ("fm0_8msps", 20, 2), ("fm0_16msps", 10, 2)]
