"""Plain float32 geometry of StabNet's multi-grid warp and of the serving
path's color warp (reference: s_net_bundle_nobm.py:29-71,
spatial_transformer3.py:62-301, deploy_bundle.py:136-146, 216-295), written
from the published semantics, with the reference's quirks kept: NDC to pixels
as (x + 1) * W / 2, corner weights from the clamped corners, a strict edge, a
projective divide nudged by 1e-8 away from zero, black where a sample leaves
[-1, 1]^2.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def base_mesh(gh: int, gw: int, device) -> torch.Tensor:
    ys = torch.arange(gh + 1, dtype=torch.float32, device=device) * (2.0 / gh) - 1.0
    xs = torch.arange(gw + 1, dtype=torch.float32, device=device) * (2.0 / gw) - 1.0
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([x, y], dim=-1)


def theta_to_mesh(theta: torch.Tensor, cfg: dict) -> torch.Tensor:
    gh, gw = cfg["grid_h"], cfg["grid_w"]
    mesh = base_mesh(gh, gw, theta.device) + theta.float().reshape(-1, gh + 1, gw + 1, 2)
    bound = 1.0 / cfg["do_crop_rate"]
    return mesh.clamp(-bound, bound)


def cell_corners(mesh: torch.Tensor) -> torch.Tensor:
    """(B, gh+1, gw+1, 2) -> (B, gh, gw, 4, 2), corners tl, tr, bl, br."""
    return torch.stack([mesh[:, :-1, :-1], mesh[:, :-1, 1:], mesh[:, 1:, :-1],
                        mesh[:, 1:, 1:]], dim=-2)


def homographies(mesh: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Per cell, H with H [x_src, y_src, 1] ~ [x_dst, y_dst, 1] from the
    regular output cell to the mesh quad: the 8x8 DLT system plus 1e-4 I,
    solved (spatial_transformer3.py:144-198)."""
    gh, gw = cfg["grid_h"], cfg["grid_w"]
    src = cell_corners(base_mesh(gh, gw, mesh.device)[None]).expand(mesh.shape[0], -1, -1, -1, -1)
    dst = cell_corners(mesh)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    top = torch.stack([x, y, o, z, z, z, -x * u, -y * u], dim=-1)
    bot = torch.stack([z, z, z, x, y, o, -x * v, -y * v], dim=-1)
    A = torch.cat([top, bot], dim=-2) + 1e-4 * torch.eye(8, device=mesh.device)
    b = torch.cat([u, v], dim=-1)[..., None]
    h = torch.linalg.solve(A, b)[..., 0]
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(h.shape[:-1] + (3, 3))


def cell_axis(n: int, cells: int, device) -> torch.Tensor:
    """Mesh cell of each pixel along an axis: cells n // cells long, the last
    taking the remainder."""
    return torch.clamp(torch.arange(n, device=device) // (n // cells), max=cells - 1)


def dense_maps(Hs: torch.Tensor, height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, gh, gw, 3, 3) -> NDC sampling maps (B, height, width) each: every
    output pixel's NDC position through its cell's homography."""
    B, gh, gw = Hs.shape[:3]
    dev = Hs.device
    gx = torch.linspace(-1.0, 1.0, width, device=dev)
    gy = torch.linspace(-1.0, 1.0, height, device=dev)
    rows, cols = cell_axis(height, gh, dev), cell_axis(width, gw, dev)
    h = Hs.reshape(B, gh, gw, 9)[:, rows][:, :, cols]          # (B, H, W, 9)
    X = h[..., 0] * gx + h[..., 1] * gy[:, None] + h[..., 2]
    Y = h[..., 3] * gx + h[..., 4] * gy[:, None] + h[..., 5]
    Z = h[..., 6] * gx + h[..., 7] * gy[:, None] + h[..., 8]
    Z = Z + torch.where(Z >= 0, 1e-8, -1e-8)
    return X / Z, Y / Z


def black_mask(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x < -1) | (x > 1) | (y < -1) | (y > 1)).float()


def sample(im: torch.Tensor, x_ndc: torch.Tensor, y_ndc: torch.Tensor,
           strict_edge: bool = True) -> torch.Tensor:
    """Bilinear sample of (B, H, W, C) at NDC maps (B, Ho, Wo), weights from
    the clamped corners (spatial_transformer3.py:62-123).  The strict edge
    gives 0 at x = W - 1 or y = H - 1 exactly (the reference's); without it
    the corners step back one pixel there, so the edge pixel is read."""
    B, H, W, C = im.shape
    x = (x_ndc.float() + 1.0) * (W / 2.0)
    y = (y_ndc.float() + 1.0) * (H / 2.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    if not strict_edge:
        x0 = torch.where(x == W - 1, x0 - 1.0, x0)
        y0 = torch.where(y == H - 1, y0 - 1.0, y0)
    x0c, x1c = x0.clamp(0, W - 1), (x0 + 1).clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), (y0 + 1).clamp(0, H - 1)
    flat = im.float().reshape(B, H * W, C)

    def at(yy, xx):
        idx = (yy.long() * W + xx.long()).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(x.shape + (C,))

    wa = ((x1c - x) * (y1c - y))[..., None]
    wb = ((x1c - x) * (y - y0c))[..., None]
    wc = ((x - x0c) * (y1c - y))[..., None]
    wd = ((x - x0c) * (y - y0c))[..., None]
    return wa * at(y0c, x0c) + wb * at(y1c, x0c) + wc * at(y0c, x1c) + wd * at(y1c, x1c)


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) half-pixel-centre bilinear resize, clamped at the ends."""
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (src - lo).astype(np.float32)
    M = np.zeros((n_out, n_in), np.float32)
    np.add.at(M, (np.arange(n_out), lo), 1.0 - f)
    np.add.at(M, (np.arange(n_out), hi), f)
    return torch.from_numpy(M).to(device)


def resize(m: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., Ho, Wo), half-pixel bilinear."""
    H, W = m.shape[-2:]
    if (H, W) == tuple(out_hw):
        return m
    R = resize_matrix(H, out_hw[0], m.device)
    C = resize_matrix(W, out_hw[1], m.device)
    return torch.einsum("oh,...hw,pw->...op", R, m.float(), C)


def warp_color(color: torch.Tensor, x_map: torch.Tensor, y_map: torch.Tensor,
               out_hw: Tuple[int, int], smooth: int = 4) -> torch.Tensor:
    """The served full-resolution frame: the maps low-passed to a quarter of
    the model's size, resized to the output, and the uint8 color frame
    (B, Hf, Wf, 3) sampled there, rounded half to even and clipped."""
    B, H, W = x_map.shape
    xs = resize(resize(x_map, (H // smooth, W // smooth)), out_hw)
    ys = resize(resize(y_map, (H // smooth, W // smooth)), out_hw)
    out = sample(color, xs, ys)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def gray_host(color: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """The host's model-scale gray of (B, Hf, Wf, 3) uint8 BGR frames, as
    OpenCV makes it (the reference's cvt_img2train, config.py:6-21): BT.601
    luma rounded to uint8, a half-pixel bilinear resize rounded to uint8,
    then [0, 255] -> [-0.5, 0.5]."""
    c = color.float()
    luma = torch.round(0.114 * c[..., 0] + 0.587 * c[..., 1] + 0.299 * c[..., 2])
    return torch.round(resize(luma, hw)) / 255.0 - 0.5


def max_clear_rect(black: np.ndarray) -> Tuple[int, int, int, int]:
    """(top, left, bottom, right), inclusive, of the largest rectangle of
    pixels with no black count: the largest rectangle in the histogram of
    clear runs, row by row (the reference's search, deploy_bundle.py:344-365,
    finds no larger one)."""
    clear = np.asarray(black) <= 0
    H, W = clear.shape
    if not clear.any():
        raise ValueError("no black-free pixel")
    run = np.zeros(W, np.int64)
    best, best_area = (0, 0, 0, 0), 0
    for r in range(H):
        run = (run + 1) * clear[r]
        stack = []
        for c in range(W + 1):
            h = int(run[c]) if c < W else 0
            start = c
            while stack and stack[-1][1] >= h:
                s, sh = stack.pop()
                if sh * (c - s) > best_area:
                    best_area = sh * (c - s)
                    best = (r - sh + 1, s, r, c - 1)
                start = s
            if h > 0:
                stack.append((start, h))
    return tuple(int(v) for v in best)
