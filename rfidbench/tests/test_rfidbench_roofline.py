"""The yardstick's bounds at the bench shapes, as the kernels' own bring-up
measured them (N 9,704,304, Ny 1,940,860, 25 taps, window 100)."""

from __future__ import annotations

import pytest

from rfidbench import roofline


def test_front_y_bound_at_bench():
    b = roofline.front_y_bound(9_704_304, 1_940_860, 25)
    assert b.by == "bytes" and b.seconds * 1e3 == pytest.approx(0.0278, abs=5e-5)


def test_stack_bound_at_bench():
    b = roofline.stack_bound(1_940_860, 100)
    assert b.by == "bytes" and b.seconds * 1e3 == pytest.approx(0.0070, abs=5e-5)


def test_operations_bound():
    b = roofline.bound(0, 67e12)
    assert b.by == "operations" and b.seconds == pytest.approx(1.0)
