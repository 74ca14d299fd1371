"""The port's native crop (native/crop.cc through ctypes) against its plain
Python version and the JAX package's brute-force oracle.

The native and plain searches run the same scan, so they must return the
same rectangle; the O(H^2 W^2) oracle may break ties elsewhere, so against it
the area is compared and the rectangle checked black-free.
"""

import numpy as np
import pytest

from stabnet_tpu.ops.crop import max_clear_rect as jax_max_clear_rect
from stabnet_tpu.ops.crop import max_clear_rect_bruteforce
from stabnet_tpu_torch.native import native_ops
from stabnet_tpu_torch.ops.crop import max_clear_rect, max_clear_rect_plain


def _area(rect):
    t, l, b, r = rect
    return (b - t + 1) * (r - l + 1)


@pytest.mark.parametrize("seed", range(8))
def test_native_matches_plain_and_bruteforce(seed):
    rng = np.random.RandomState(seed)
    H, W = rng.randint(6, 20), rng.randint(6, 26)
    black = (rng.rand(H, W) < rng.uniform(0.05, 0.3)).astype(np.int32)
    black[rng.randint(H), rng.randint(W)] = 0
    got = max_clear_rect(black)
    assert got == max_clear_rect_plain(black) == jax_max_clear_rect(black)
    assert _area(got) == _area(max_clear_rect_bruteforce(black))
    t, l, b, r = got
    assert black[t: b + 1, l: r + 1].sum() == 0


def test_native_matches_plain_on_a_border_mask():
    """A serving-like map at 288x512: black borders of uneven width, counts
    above 1, a few stray black pixels inside."""
    rng = np.random.RandomState(3)
    black = np.zeros((288, 512), np.int32)
    black[:17], black[-9:], black[:, :31], black[:, -4:] = 3, 1, 2, 7
    black[rng.randint(0, 288, 40), rng.randint(0, 512, 40)] = 1
    got = max_clear_rect(black)
    assert got == max_clear_rect_plain(black)
    t, l, b, r = got
    assert black[t: b + 1, l: r + 1].sum() == 0 and _area(got) > 10_000


def test_all_clear_and_border():
    assert max_clear_rect(np.zeros((10, 20))) == (0, 0, 9, 19)
    assert max_clear_rect_plain(np.zeros((10, 20))) == (0, 0, 9, 19)
    black = np.ones((12, 16), np.int64)
    black[2:10, 3:13] = 0
    assert max_clear_rect(black) == max_clear_rect_plain(black) == (2, 3, 9, 12)


@pytest.mark.parametrize("fn", [max_clear_rect, max_clear_rect_plain])
def test_all_black_raises(fn):
    with pytest.raises(ValueError, match="no black-free pixel"):
        fn(np.ones((4, 4), np.int32))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses raises, and so does the crop."""
    bad = tmp_path / "crop.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_ops, "SRC", str(bad))
    monkeypatch.setattr(native_ops, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_ops.build()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        max_clear_rect(np.zeros((4, 4)))
