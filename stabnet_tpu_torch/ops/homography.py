"""Batched 4-point DLT homography solves for the multi-grid warp.

Reference semantics: spatial_transformer3.py:144-198 (`get_H`, `get_Hs`).  The
whole mesh is solved as ONE batched (B, grid_h, grid_w, 8, 8) linear solve.

Convention (matches the reference): for each mesh cell, `src` holds the four
regular-grid corner positions of the OUTPUT cell in NDC ([-1,1]^2) and `dst`
holds the predicted mesh vertex positions; the returned homography H satisfies
H @ [x_src, y_src, 1]^T ~ [x_dst, y_dst, 1]^T, i.e. it maps output pixels to
input-frame sampling locations.

Every caller (the per-frame step and the whole-clip loop) goes through the
one `solve_dlt` below: the streaming history feeds each frame's output back
into the next frame's input, so two solvers that differ by O(eps * cond)
would split into visible pixels over a clip.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def solve_dlt(src: torch.Tensor, dst: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Solve for homographies mapping 4 src points to 4 dst points.

    Args:
      src: (..., 4, 2) source quad corners (x, y).
      dst: (..., 4, 2) destination quad corners (x, y).
      eps: Tikhonov regularizer added to the 8x8 system diagonal
           (reference: spatial_transformer3.py:144-145 `pinv`).

    Returns:
      (..., 3, 3) homographies with H[2,2] == 1.
    """
    src = src.float()
    dst = dst.float()
    x, y = src[..., 0], src[..., 1]          # (..., 4)
    u, v = dst[..., 0], dst[..., 1]          # (..., 4)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)

    # Rows 0-3:  [x y 1 0 0 0 -x*u -y*u] ; rows 4-7: [0 0 0 x y 1 -x*v -y*v]
    # (same layout as reference spatial_transformer3.py:159-168)
    top = torch.stack([x, y, one, zero, zero, zero, -x * u, -y * u], dim=-1)
    bot = torch.stack([zero, zero, zero, x, y, one, -x * v, -y * v], dim=-1)
    A = torch.cat([top, bot], dim=-2)                      # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)[..., None]               # (..., 8, 1)

    A = A + eps * torch.eye(8, dtype=A.dtype, device=A.device)
    # The reference computes inv(A + eps I) @ b; a batched LU solve is the
    # equivalent.  `solve_ex` skips the singularity check, which would make
    # the host wait for the device on every frame (A + eps I is regular).
    h = torch.linalg.solve_ex(A, b).result[..., 0]         # (..., 8)
    ones = torch.ones(h.shape[:-1] + (1,), dtype=h.dtype, device=h.device)
    return torch.cat([h, ones], dim=-1).reshape(h.shape[:-1] + (3, 3))


@functools.lru_cache(maxsize=None)
def cell_src_corners(grid_h: int, grid_w: int) -> np.ndarray:
    """Regular-grid NDC corner quads for every mesh cell.

    Returns (grid_h, grid_w, 4, 2) float32 with corner order
    (top-left, top-right, bottom-left, bottom-right) — the order used by the
    reference when assembling `ori` (spatial_transformer3.py:187-189).
    """
    h = 2.0 / grid_h
    w = 2.0 / grid_w
    out = np.zeros((grid_h, grid_w, 4, 2), np.float32)
    for i in range(grid_h):
        for j in range(grid_w):
            hh = i * h - 1.0
            ww = j * w - 1.0
            out[i, j] = [[ww, hh], [ww + w, hh], [ww, hh + h], [ww + w, hh + h]]
    return out


@functools.lru_cache(maxsize=None)
def _device_src_corners(grid_h: int, grid_w: int, device: torch.device) -> torch.Tensor:
    # Cached on the device: a per-frame upload from pageable host memory
    # would make the host wait for the device's queue.
    return torch.from_numpy(cell_src_corners(grid_h, grid_w)).to(device)


def mesh_cell_corners(mesh: torch.Tensor) -> torch.Tensor:
    """(..., grid_h+1, grid_w+1, 2) vertices -> (..., grid_h, grid_w, 4, 2)
    quads in (tl, tr, bl, br) order (reference: spatial_transformer3.py:191-193)."""
    tl = mesh[..., :-1, :-1, :]
    tr = mesh[..., :-1, 1:, :]
    bl = mesh[..., 1:, :-1, :]
    br = mesh[..., 1:, 1:, :]
    return torch.stack([tl, tr, bl, br], dim=-2)


def mesh_to_homographies(mesh: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """(B, grid_h+1, grid_w+1, 2) mesh -> (B, grid_h, grid_w, 3, 3) homographies
    mapping regular output-cell corners to mesh vertices (one batched solve)."""
    src = _device_src_corners(grid_h, grid_w, mesh.device)
    src = src.expand(mesh.shape[:-3] + src.shape)
    dst = mesh_cell_corners(mesh)                          # (B, gh, gw, 4, 2)
    return solve_dlt(src, dst)


def apply_homography(H: torch.Tensor, pts: torch.Tensor,
                     z_eps: float = 1e-8) -> torch.Tensor:
    """Apply (..., 3, 3) homographies to (..., N, 2) points.

    The divisor z is nudged away from zero by +/-1e-8 with sign(z>=0)
    (reference: spatial_transformer3.py:253-260).
    """
    ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype, device=pts.device)
    p = torch.cat([pts, ones], dim=-1)                     # (..., N, 3)
    q = torch.einsum("...ij,...nj->...ni", H, p)
    z = q[..., 2]
    sign = torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
    z = z + sign * z_eps
    return q[..., :2] / z[..., None]
