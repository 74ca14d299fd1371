"""K2m, the serving warp (stabnet_tpu_torch/ops/cuda_warp.py `warp_mesh`),
against the JAX package.

On the CPU `warp_mesh` runs its plain version, `warp_mesh_plain`.  The JAX
side is the chain it fuses: `dense_maps` + `black_mask` + the Pallas sampler
in interpret mode (exact=True), each package from the same mesh through its
own `mesh_to_homographies`.  Tolerances: maps 1e-5 absolute (two batched LU
solves and two summation orders); output 1e-5 absolute (a smooth image, so
a map difference of that order moves a sample by far less); the black mask
equal wherever both maps lie more than 1e-6 from +/-1, as in
tests/test_torch_ops.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabnet_tpu.ops import homography as jhom
from stabnet_tpu.ops import pallas_warp
from stabnet_tpu.ops import warp as jwarp
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops import homography as thom
from stabnet_tpu_torch.ops import warp as twarp
from stabnet_tpu_torch.ops.mesh import base_mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mesh(rng, B, zoom=1.0, spread=0.08, grid=4):
    """A (B, grid + 1, grid + 1, 2) mesh, its vertices moved by up to
    spread * 4 / grid (the same share of a cell at any grid)."""
    s = spread * 4 / grid
    m = base_mesh(grid, grid) * zoom + rng.uniform(-s, s, (B, grid + 1, grid + 1, 2))
    return m.astype(np.float32)


def _smooth_image(rng, B, H, W):
    """Low-frequency random images in about [0, 1]: a few pixels of map
    error change a sample by little."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(B):
        a, b, c, d = rng.uniform(0.05, 0.2, 4)
        p, q = rng.uniform(0, 2 * np.pi, 2)
        out.append(0.5 + 0.25 * np.sin(a * xx + b * yy + p) + 0.2 * np.cos(c * xx - d * yy + q))
    return np.stack(out)[..., None].astype(np.float32)


CASES = {   # frame size, mesh zoom, mesh cells per side
    "tiny 48x64": ((48, 64), 1.0, 4),
    "ragged 50x66": ((50, 66), 1.0, 4),
    "zoomed out, samples out of frame": ((48, 64), 1.2, 4),
    "8x8 mesh": ((48, 64), 1.0, 8),
    "ragged 40x150, cells of 37 and 39 columns": ((40, 150), 1.0, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_mesh_matches_jax(case):
    (H, W), zoom, g = CASES[case]
    rng = np.random.RandomState(7)
    B = 2
    mesh = _mesh(rng, B, zoom, grid=g)
    im = _smooth_image(rng, B, H, W)

    Hs_j = jhom.mesh_to_homographies(jnp.asarray(mesh), g, g)
    jx, jy = jwarp.dense_maps(Hs_j, H, W)
    jblack = np.asarray(jwarp.black_mask(jx, jy))
    jout = np.asarray(pallas_warp.bilinear_sample_pallas(
        jnp.asarray(im), jx, jy, y_band=32, x_band=128, interpret=True, exact=True))
    jx, jy = np.asarray(jx), np.asarray(jy)

    Hs_t = thom.mesh_to_homographies(torch.from_numpy(mesh), g, g)
    before = cuda_warp.warp_mesh.launches
    out, black, x, y = cuda_warp.warp_mesh(torch.from_numpy(im), Hs_t,
                                           twarp.mesh_tables(H, W, g, g, CPU))
    assert cuda_warp.warp_mesh.launches == before      # CPU: the plain version
    assert out.shape == (B, H, W, 1) and black.shape == x.shape == y.shape == (B, H, W)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    clear = ((np.abs(np.abs(jx) - 1) > 1e-6) & (np.abs(np.abs(jy) - 1) > 1e-6))
    np.testing.assert_array_equal(black.numpy()[clear], jblack[clear])
    share = float(black.mean())
    if zoom > 1.0:   # a black border, most of it sampled as 0 (the rest fades out)
        assert 0.2 < share < 0.9 and float((out[..., 0] == 0)[black > 0].float().mean()) > 0.5
    else:
        assert share < 0.2

    # `transformer` is this one call.
    res = twarp.transformer(torch.from_numpy(im), torch.from_numpy(mesh), g, g)
    for got, want in zip((res.output, res.black_pix, res.x_map, res.y_map),
                         (out, black, x, y)):
        assert torch.equal(got, want)
    assert torch.equal(res.Hs, Hs_t)


def test_warp_mesh_reads_the_frame_in_place():
    """The current frame as a channel of the 13-channel stack, in the layout
    `assemble_input` gives it (planes, pixel stride 1) and the one a refine
    pass gives it (channels last, pixel stride 13), warps exactly as the
    same frame copied out contiguous.  The serving maps (explicit order)
    stay within a few ulps of the training maps (`dense_maps`' einsum)."""
    rng = np.random.RandomState(8)
    B, H, W, C = 2, 48, 64, 13
    mesh = torch.from_numpy(_mesh(rng, B, spread=0.15))
    Hs = thom.mesh_to_homographies(mesh, 4, 4)
    tables = twarp.mesh_tables(H, W, 4, 4, CPU)
    planes = torch.from_numpy(rng.rand(B, C, H, W).astype(np.float32))
    for stack in (planes.permute(0, 2, 3, 1), planes.permute(0, 2, 3, 1).contiguous()):
        frame = stack[..., C - 1: C]
        assert not frame.is_contiguous()
        got = cuda_warp.warp_mesh(frame, Hs, tables)
        want = cuda_warp.warp_mesh(frame.contiguous(), Hs, tables)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    x, y = got[2], got[3]
    dx, dy = twarp.dense_maps(Hs, H, W)
    for serve, train in ((x, dx), (y, dy)):
        keep = train.abs() <= 1.5
        assert float((serve - train)[keep].abs().max()) <= 1e-6


# (B, H, W, column stride of the frame) -> K2m's pixels per thread.
LAYOUTS = {
    "online S=1, one pixel per thread": ((1, 288, 512, 1), 1),
    "chip_smoke's S=2 refine stack, one": ((2, 288, 512, 13), 1),
    "S=2 planes, about one wave: one": ((2, 288, 512, 1), 1),
    "serving clip S=4, four": ((4, 288, 512, 1), 4),
    "bench batch S=6, four": ((6, 288, 512, 1), 4),
    "bench batch S=6 ragged 289x515, four": ((6, 289, 515, 1), 4),
    "ragged S=1 289x515, one": ((1, 289, 515, 1), 1),
    "debug forward S=10 channels last, one": ((10, 288, 512, 13), 1),
    "a one-pixel-wide frame, four": ((4000, 288, 1, 13), 4),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_warp_mesh_layout_at_the_path_shapes(case):
    """The wrapper's choice of K2m's layout, a pure function of the batch,
    the frame size and the frame's column stride (csrc/warp.cu, K2m): one
    pixel per thread where the grid is at most about two waves of the
    card or the frame is strided, else four.  The mesh does not enter it,
    so an 8 x 8 mesh runs the layout a 4 x 4 one does."""
    (B, H, W, col_stride), pix = LAYOUTS[case]
    assert cuda_warp.warp_mesh_pix(B, H, W, col_stride) == pix


REFUSED_MESHES = {
    "homographies of another batch": ((2, 48, 64, 1), (1, 4, 4, 3, 3)),
    # A cell must be at least one pixel.
    "cells finer than the frame": ((1, 3, 64, 1), (1, 4, 4, 3, 3)),
    "not 3x3 homographies": ((1, 48, 64, 1), (1, 4, 4, 2, 3)),
    "more than one channel": ((1, 48, 64, 3), (1, 4, 4, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(REFUSED_MESHES))
def test_warp_mesh_refuses_what_the_kernel_does_not_take(case):
    """Checked on every device, before any is touched (the meta device holds
    no memory), so the plain version takes exactly what K2m takes."""
    im_shape, hs_shape = REFUSED_MESHES[case]
    meta = torch.device("meta")
    im = torch.empty(im_shape, device=meta)
    Hs = torch.empty(hs_shape, device=meta)
    tables = twarp.mesh_tables(im_shape[1], im_shape[2], 1, 1, meta)
    with pytest.raises(ValueError, match="warp_mesh"):
        cuda_warp.warp_mesh(im, Hs, tables)
