"""Multi-grid warp engine: dense sampling maps, border masks, bilinear sampling.

Reference semantics: spatial_transformer3.py:200-301 (`_meshgrid2`,
`_transform3`, `_interpolate`).  The whole map is produced by ONE einsum over a
(grid_h, cell_h, grid_w, cell_w) blocked pixel grid.

Numerics preserved from the reference (required for output parity):
  * output-pixel NDC grid uses linspace(-1, 1, n), built in numpy
    (spatial_transformer3.py:200-207),
  * projective divide guards z with +/-1e-8 by sign(z >= 0)
    (spatial_transformer3.py:253-260),
  * NDC -> input pixel uses (x + 1) * W / 2  (NOT (W-1)/2)
    (spatial_transformer3.py:80-82),
  * bilinear corner indices are clamped to the image and the interpolation
    weights are computed FROM THE CLAMPED corners
    (spatial_transformer3.py:85-121),
  * black mask = 1.0 where the sample coordinate leaves [-1, 1]^2
    (spatial_transformer3.py:282-286).

The sampler itself lives beside its CUDA kernel in `ops/cuda_warp.py`;
`bilinear_sample` here is its plain version, and `transformer` goes through
the kernel's wrapper (the plain version on CPU tensors).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops import homography as hom
from stabnet_tpu_torch.ops.cuda_warp import bilinear_sample_plain as bilinear_sample

__all__ = ["WarpResult", "dense_maps", "black_mask", "bilinear_sample",
           "transformer"]


class WarpResult(NamedTuple):
    """Outputs of the multi-grid warp (reference: `transformer` return)."""

    output: torch.Tensor     # (B, H, W, C) warped image
    black_pix: torch.Tensor  # (B, H, W)   1.0 where sample fell outside input
    x_map: torch.Tensor      # (B, H, W)   NDC x sampling map
    y_map: torch.Tensor      # (B, H, W)   NDC y sampling map
    Hs: torch.Tensor         # (B, grid_h, grid_w, 3, 3) per-cell homographies


@functools.lru_cache(maxsize=None)
def _ndc_grid(height: int, width: int) -> np.ndarray:
    """Homogeneous NDC coordinates of the output pixel grid: (H, W, 3)."""
    xs = np.linspace(-1.0, 1.0, width, dtype=np.float32)
    ys = np.linspace(-1.0, 1.0, height, dtype=np.float32)
    x_t, y_t = np.meshgrid(xs, ys)
    return np.stack([x_t, y_t, np.ones_like(x_t)], axis=-1)


@functools.lru_cache(maxsize=None)
def _cell_id_map(height: int, width: int, grid_h: int, grid_w: int) -> np.ndarray:
    """(H, W) int32 mesh-cell index per output pixel.

    Cells are floor(height/grid_h) tall; the last row/column of cells absorbs
    the remainder (reference: spatial_transformer3.py:227-243).
    """
    gh = height // grid_h
    gw = width // grid_w
    rows = np.minimum(np.arange(height) // gh, grid_h - 1)
    cols = np.minimum(np.arange(width) // gw, grid_w - 1)
    return (rows[:, None] * grid_w + cols[None, :]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_grid(height: int, width: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ndc_grid(height, width)).to(device)


@functools.lru_cache(maxsize=None)
def _device_cell_ids(height: int, width: int, grid_h: int, grid_w: int,
                     device: torch.device) -> torch.Tensor:
    ids = _cell_id_map(height, width, grid_h, grid_w).reshape(-1)
    return torch.from_numpy(ids).long().to(device)


def dense_maps(Hs: torch.Tensor, height: int, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, grid_h, grid_w, 3, 3) homographies -> (x_map, y_map), each
    (B, height, width), in NDC."""
    B, grid_h, grid_w = Hs.shape[0], Hs.shape[1], Hs.shape[2]
    grid = _device_grid(height, width, Hs.device)          # (H, W, 3)

    if height % grid_h == 0 and width % grid_w == 0:
        gh, gw = height // grid_h, width // grid_w
        blocked = grid.reshape(grid_h, gh, grid_w, gw, 3)
        # One batched contraction over all cells (reference: a 16-iteration
        # Python loop, spatial_transformer3.py:231-269).
        T = torch.einsum("bijxy,ihjwy->bihjwx", Hs, blocked)
        T = T.reshape(B, height, width, 3)
    else:
        # Non-divisible fall-back: gather each pixel's cell homography.
        cid = _device_cell_ids(height, width, grid_h, grid_w, Hs.device)
        H_pix = Hs.reshape(B, grid_h * grid_w, 3, 3)[:, cid]  # (B, H*W, 3, 3)
        T = torch.einsum("bnxy,ny->bnx", H_pix, grid.reshape(-1, 3))
        T = T.reshape(B, height, width, 3)

    z = T[..., 2]
    sign = torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
    z = z + sign * 1e-8
    return T[..., 0] / z, T[..., 1] / z


def black_mask(x_map: torch.Tensor, y_map: torch.Tensor) -> torch.Tensor:
    """1.0 where the sampling coordinate leaves the input frame
    (reference: spatial_transformer3.py:282-286)."""
    oob = (x_map < -1.0) | (x_map > 1.0) | (y_map < -1.0) | (y_map > 1.0)
    return oob.to(x_map.dtype)


def transformer(U: torch.Tensor, mesh: torch.Tensor, grid_h: int,
                grid_w: int) -> WarpResult:
    """Warp images by a predicted multi-grid mesh.

    Args:
      U: (B, H, W, C) float32 images to warp (the current unstable frame).
      mesh: (B, grid_h+1, grid_w+1, 2) predicted mesh vertices in NDC.

    Returns:
      WarpResult with the warped image (sampled by kernel K2 on CUDA), the
      black-border mask, the dense maps and the per-cell homographies.

    Reference: spatial_transformer3.py:19,218-301 `transformer`/`_transform3`.
    """
    B, H, W, _ = U.shape
    Hs = hom.mesh_to_homographies(mesh, grid_h, grid_w)
    x_map, y_map = dense_maps(Hs, H, W)
    black = black_mask(x_map, y_map)
    output = cuda_warp.bilinear_sample(U.contiguous(), x_map.contiguous(),
                                       y_map.contiguous())
    return WarpResult(output=output, black_pix=black, x_map=x_map, y_map=y_map,
                      Hs=Hs)
