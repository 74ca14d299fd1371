"""Maximal black-free crop rectangle post-processing.

After stabilizing a whole clip, the union of per-frame black borders is
accumulated and the largest axis-aligned rectangle containing no black pixel is
cut from every frame (reference: deploy_bundle.py:344-371, an O(H^2 W^2)
prefix-sum brute force with strided start points).

This is the exact O(H*W) largest-rectangle-in-histogram algorithm; it never
returns a smaller rectangle than the reference search.  `max_clear_rect` runs
it as native C++ (native/crop.cc, built with g++ at first use; a failed build
raises); `max_clear_rect_plain` is the same scan in Python, the tests'
yardstick.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def max_clear_rect(black: np.ndarray) -> Tuple[int, int, int, int]:
    """Largest all-clear rectangle in an accumulated black-pixel count map,
    by the native library (see `max_clear_rect_plain` for the contract)."""
    from stabnet_tpu_torch.native import native_ops

    return native_ops.max_clear_rect(black)


def max_clear_rect_plain(black: np.ndarray) -> Tuple[int, int, int, int]:
    """Largest all-clear rectangle in an accumulated black-pixel count map.

    Args:
      black: (H, W) array; a pixel is "black" (excluded) if > 0.

    Returns:
      (top, left, bottom, right) inclusive bounds of the largest rectangle
      with no black pixels (same convention as the reference's `ans`,
      deploy_bundle.py:349-365).  Returns (0, 0, H-1, W-1) for an all-clear
      map and raises ValueError if every pixel is black.
    """
    clear = (np.asarray(black) <= 0)
    H, W = clear.shape
    if not clear.any():
        raise ValueError("no black-free pixel; cannot crop")

    # heights[r, c] = number of consecutive clear pixels ending at row r.
    heights = np.zeros((H, W), np.int64)
    run = np.zeros(W, np.int64)
    for r in range(H):
        run = (run + 1) * clear[r]
        heights[r] = run

    best = (0, 0, 0, 0)
    best_area = 0
    for r in range(H):
        # Largest rectangle in histogram via monotonic stack.
        stack = []  # (start_col, height)
        row = heights[r]
        for c in range(W + 1):
            h = row[c] if c < W else 0
            start = c
            while stack and stack[-1][1] >= h:
                s, sh = stack.pop()
                area = sh * (c - s)
                if area > best_area:
                    best_area = area
                    best = (r - sh + 1, s, r, c - 1)
                start = s
            if h > 0:
                stack.append((start, h))
    top, left, bottom, right = (int(v) for v in best)
    return top, left, bottom, right
