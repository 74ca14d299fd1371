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

The sampler itself lives beside its CUDA kernels in `ops/cuda_warp.py`;
`bilinear_sample` here is its plain version.  `transformer` (serving) goes
through K2m, `cuda_warp.warp_mesh`, which computes the maps, the mask and the
sample in one launch on CUDA tensors (its plain version on CPU tensors);
training builds the maps with `dense_maps`, whose einsum carries gradients.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops import homography as hom
from stabnet_tpu_torch.ops.cuda_warp import bilinear_sample_plain as bilinear_sample
from stabnet_tpu_torch.utils import device_constant

__all__ = ["WarpResult", "MeshTables", "mesh_tables", "dense_maps", "black_mask",
           "bilinear_sample", "transformer"]


class WarpResult(NamedTuple):
    """Outputs of the multi-grid warp (reference: `transformer` return)."""

    output: torch.Tensor     # (B, H, W, C) warped image
    black_pix: torch.Tensor  # (B, H, W)   1.0 where sample fell outside input
    x_map: torch.Tensor      # (B, H, W)   NDC x sampling map
    y_map: torch.Tensor      # (B, H, W)   NDC y sampling map
    Hs: torch.Tensor         # (B, grid_h, grid_w, 3, 3) per-cell homographies


def _ndc_axis(n: int) -> np.ndarray:
    """NDC coordinates of n output pixels along one axis: (n,) float32."""
    return np.linspace(-1.0, 1.0, n, dtype=np.float32)


def _cell_axis(n: int, cells: int) -> np.ndarray:
    """(n,) int32 mesh cell of each pixel along one axis: cells are
    floor(n / cells) long and the last absorbs the remainder (reference:
    spatial_transformer3.py:227-243)."""
    return np.minimum(np.arange(n) // (n // cells), cells - 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ndc_grid(height: int, width: int) -> np.ndarray:
    """Homogeneous NDC coordinates of the output pixel grid: (H, W, 3)."""
    x_t, y_t = np.meshgrid(_ndc_axis(width), _ndc_axis(height))
    return np.stack([x_t, y_t, np.ones_like(x_t)], axis=-1)


@functools.lru_cache(maxsize=None)
def _cell_id_map(height: int, width: int, grid_h: int, grid_w: int) -> np.ndarray:
    """(H, W) int32 mesh-cell index per output pixel."""
    rows, cols = _cell_axis(height, grid_h), _cell_axis(width, grid_w)
    return (rows[:, None] * grid_w + cols[None, :]).astype(np.int32)


class MeshTables(NamedTuple):
    """The per-axis tables K2m reads instead of a dense grid."""

    gx: torch.Tensor        # (W,) float32 NDC x of each output column
    gy: torch.Tensor        # (H,) float32 NDC y of each output row
    cell_col: torch.Tensor  # (W,) int32 mesh-cell column of each output column
    cell_row: torch.Tensor  # (H,) int32 mesh-cell row of each output row


@functools.lru_cache(maxsize=None)
def mesh_tables(height: int, width: int, grid_h: int, grid_w: int,
                device: torch.device) -> MeshTables:
    """`MeshTables` of a (grid_h, grid_w) mesh on (height, width) frames, on
    `device`, cached: the serving warp reads them every frame."""
    arrays = (_ndc_axis(width), _ndc_axis(height), _cell_axis(width, grid_w),
              _cell_axis(height, grid_h))
    return MeshTables(*(device_constant(a, device) for a in arrays))


@functools.lru_cache(maxsize=None)
def _device_grid(height: int, width: int, device: torch.device) -> torch.Tensor:
    return device_constant(_ndc_grid(height, width), device)


@functools.lru_cache(maxsize=None)
def _device_cell_ids(height: int, width: int, grid_h: int, grid_w: int,
                     device: torch.device) -> torch.Tensor:
    ids = _cell_id_map(height, width, grid_h, grid_w).reshape(-1)
    return device_constant(ids.astype(np.int64), device)


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
      U: (B, H, W, 1) float32 frames to warp (the current unstable frame),
        at any strides.
      mesh: (B, grid_h+1, grid_w+1, 2) predicted mesh vertices in NDC.

    Returns:
      WarpResult with the warped image, the black-border mask, the dense maps
      and the per-cell homographies.  The maps, the mask and the sample come
      from one launch of kernel K2m on CUDA (`cuda_warp.warp_mesh`, its plain
      version on the CPU), which reads U in place at its strides: U is the
      current frame's channel of the input stack, one channel.  It carries
      no gradient (training builds the warp from `dense_maps`).

    Reference: spatial_transformer3.py:19,218-301 `transformer`/`_transform3`.
    """
    B, H, W, _ = U.shape
    Hs = hom.mesh_to_homographies(mesh, grid_h, grid_w)
    output, black, x_map, y_map = cuda_warp.warp_mesh(
        U, Hs, mesh_tables(H, W, grid_h, grid_w, U.device))
    return WarpResult(output=output, black_pix=black, x_map=x_map, y_map=y_map,
                      Hs=Hs)
