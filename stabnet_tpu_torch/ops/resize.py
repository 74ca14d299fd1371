"""Half-pixel bilinear resize of (..., H, W) maps, and the fused
resize-and-crop of the training augmentation.

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


def resize_bilinear_hwc(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., Ho, Wo, C)."""
    return resize_bilinear_bhw(img.movedim(-1, -3), out_hw).movedim(-3, -1)


def _dyn_axis_matrix(n_out: int, n_in: int, big_n: int,
                     offset: torch.Tensor) -> torch.Tensor:
    """(..., n_out, n_in) interpolation matrices for a fused up-sample to
    `big_n` and crop at `offset` (a tensor of any batch shape): row o
    samples the source at (o + offset + 0.5) * (n_in / big_n) - 0.5, the
    value a half-pixel bilinear resize to `big_n` holds at o + offset."""
    dev = offset.device
    o = torch.arange(n_out, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(n_in, dtype=torch.float32, device=dev)[None, :]
    off = offset.float()[..., None, None]
    src = ((o + off + 0.5) * (n_in / big_n) - 0.5).clamp(0.0, n_in - 1)
    return (1.0 - (src - i).abs()).clamp_min(0.0)


def resize_crop_hwc(img: torch.Tensor, big_hw: Tuple[int, int],
                    crop_h: torch.Tensor, crop_w: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (..., H, W, C) to `big_hw`, then crop `out_hw` at
    (crop_h, crop_w) (tensors of the batch shape `...`), as two matrix
    products; the big intermediate is never built."""
    H, W = img.shape[-3], img.shape[-2]
    Rr = _dyn_axis_matrix(out_hw[0], H, big_hw[0], crop_h)        # (..., Ho, H)
    Rc = _dyn_axis_matrix(out_hw[1], W, big_hw[1], crop_w)        # (..., Wo, W)
    out = torch.einsum("...oh,...hwc->...owc", Rr, img.float())
    return torch.einsum("...pw,...owc->...opc", Rc, out)
