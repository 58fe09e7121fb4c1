"""The yardstick's counts."""

import pytest

from benchmark import roofline


def test_wgs_forward_flops():
    assert roofline.forward_flops(100, 221, 7) == pytest.approx(
        2.0105e9, rel=1e-4)


def test_wgs_paint_bytes_per_512_plans():
    assert roofline.paint_bytes(512, 100, 221, 7, 5, False) == \
        pytest.approx(101.4e6, rel=1e-3)


def test_longread_paint_bytes_per_512_plans():
    assert roofline.paint_bytes(512, 100, 147, 10, 5, True) == \
        pytest.approx(104.7e6, rel=1e-3)


def test_train_flops_are_three_forwards():
    assert roofline.train_flops(100, 147, 10) == 3 * roofline.forward_flops(
        100, 147, 10)
