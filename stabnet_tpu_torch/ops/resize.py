"""Half-pixel bilinear resize of (..., H, W) maps.

The weights are the JAX package's static resize matrices, built in numpy the
same way (`resize_matrix`).  Each row of such a matrix has at most two
nonzeros, so the contraction is applied as a two-tap gather along each axis
(rows first, then columns) instead of a dense matrix product: the same sum,
in a fixed order that the fused up-sample of the color-warp kernel
(`ops/cuda_warp.py`, K1) reproduces bit for bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear half-pixel-center resize weights."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (src - lo).astype(np.float32)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), lo] += 1.0 - f
    M[np.arange(n_out), hi] += f
    return M


@functools.lru_cache(maxsize=None)
def resize_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, ...]:
    """The two nonzeros of each row of `resize_matrix(n_in, n_out)`.

    Returns (lo, hi, w_lo, w_hi): int32 source indices and float32 weights,
    each (n_out,).  Where both taps fall on one source pixel (the clamped
    ends), w_lo carries the whole weight and w_hi is 0.
    """
    M = resize_matrix(n_in, n_out)
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    rows = np.arange(n_out)
    w_lo = M[rows, lo]
    w_hi = np.where(hi != lo, M[rows, hi], np.float32(0.0)).astype(np.float32)
    return lo.astype(np.int32), hi.astype(np.int32), w_lo, w_hi


@functools.lru_cache(maxsize=None)
def device_taps(n_in: int, n_out: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """`resize_taps` as tensors on `device`, cached: the indexing below and
    kernel K1 read them every frame."""
    return tuple(torch.from_numpy(a).to(device) for a in resize_taps(n_in, n_out))


def resize_bilinear_bhw(m: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., Ho, Wo): batched over leading dims."""
    H, W = m.shape[-2], m.shape[-1]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return m
    lo, hi, w_lo, w_hi = device_taps(H, Ho, m.device)
    rows = w_lo[:, None] * m[..., lo, :] + w_hi[:, None] * m[..., hi, :]
    lo, hi, w_lo, w_hi = device_taps(W, Wo, m.device)
    return w_lo * rows[..., lo] + w_hi * rows[..., hi]
