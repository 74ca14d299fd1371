"""Mesh geometry: regressor output (theta) -> warp mesh and per-cell quads.

Reference semantics: s_net_bundle_nobm.py:29-71 (`get_4_pts`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stabnet_tpu_torch.ops.homography import mesh_cell_corners
from stabnet_tpu_torch.utils import device_constant


@functools.lru_cache(maxsize=None)
def base_mesh(grid_h: int, grid_w: int) -> np.ndarray:
    """Regular NDC vertex grid: (grid_h+1, grid_w+1, 2) with (x, y) entries.

    Vertex (i, j) sits at (j * 2/grid_w - 1, i * 2/grid_h - 1)
    (reference: s_net_bundle_nobm.py:44-46).
    """
    ys = np.arange(grid_h + 1, dtype=np.float32) * (2.0 / grid_h) - 1.0
    xs = np.arange(grid_w + 1, dtype=np.float32) * (2.0 / grid_w) - 1.0
    x_t, y_t = np.meshgrid(xs, ys)
    return np.stack([x_t, y_t], axis=-1)


@functools.lru_cache(maxsize=None)
def _device_base_mesh(grid_h: int, grid_w: int, device: torch.device) -> torch.Tensor:
    # Cached on the device: a per-frame upload from pageable host memory
    # would make the host wait for the device's queue.
    return device_constant(base_mesh(grid_h, grid_w), device)


def theta_to_mesh(theta: torch.Tensor, grid_h: int, grid_w: int,
                  do_crop_rate: float) -> torch.Tensor:
    """Predicted vertex offsets -> clamped mesh vertex positions.

    Args:
      theta: (B, (grid_h+1)*(grid_w+1)*2) per-vertex (dx, dy) offsets in the
        row-major vertex order used by the reference head.
      do_crop_rate: vertices are clamped to +/- 1/do_crop_rate
        (reference: s_net_bundle_nobm.py:37,58).

    Returns:
      (B, grid_h+1, grid_w+1, 2) mesh vertices ("pts2" in the reference).
    """
    B = theta.shape[0]
    offsets = theta.reshape(B, grid_h + 1, grid_w + 1, 2).float()
    mesh = _device_base_mesh(grid_h, grid_w, theta.device) + offsets
    bound = 1.0 / do_crop_rate
    return mesh.clamp(-bound, bound)


def cell_pts(mesh: torch.Tensor) -> torch.Tensor:
    """Per-cell corner bundles ("pts1"): (B, grid_h, grid_w, 8).

    Layout [x_tl, x_tr, x_bl, x_br, y_tl, y_tr, y_bl, y_br], matching the
    reference's reshape of stacked (x-row, y-row) corner matrices
    (s_net_bundle_nobm.py:63-68).
    """
    corners = mesh_cell_corners(mesh)                  # (B, gh, gw, 4, 2)
    return torch.cat([corners[..., 0], corners[..., 1]], dim=-1)
