"""The roofline counts reproduce the byte counts of the port's kernel table
(PERF.md, "The TPU kernels"), and a share is bounded by the card's rates."""

import pytest

from benchmarks.roofline import k1, k2, k2m, k4, k6b, least_seconds


@pytest.mark.parametrize("args,want", [
    ((1, 3, 720, 1280, 720, 1280, 72, 128), 5_603_328),
    ((4, 3, 720, 1280, 720, 1280, 72, 128), 22_413_312),
    ((1, 3, 1080, 1920, 1080, 1920, 72, 128), 12_515_328),
    ((6, 3, 720, 1280, 720, 1280, 72, 128), 33_619_968),
])
def test_k1(args, want):
    assert k1.nbytes(*args) == want


@pytest.mark.parametrize("B,want", [(1, 2_956_096), (4, 11_805_184), (6, 17_704_576)])
def test_k2m(B, want):
    assert k2m.nbytes(B, 288, 512) == want


def test_k2_k4_k6b():
    assert k2.nbytes(10, 288, 512, 2, 288, 512) == 35_389_440
    assert k2.nbytes(20, 288, 512, 1, 288, 512) == 47_185_920
    assert k4.nbytes(10, 288, 512, 2, 288, 512) == 35_389_440
    assert k6b.nbytes(20, 288, 512, 1, 288, 512) == 70_778_880


def test_least_time_is_the_bytes_bound():
    t = least_seconds(k2m.nbytes(6, 288, 512), k2m.ops(6, 288, 512), "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(17_704_576 / 3.35e12)
    assert least_seconds(1, 1, "cpu") is None
