"""The port's warp kernels (stabnet_tpu_torch/ops/cuda_warp.py) and, on the
card, the TV-L1 iteration K7 (ops/flow.py; its CPU tests are in
tests/test_torch_flow.py).

On the CPU the wrappers run their plain versions; those are held here to the
JAX package's Pallas kernels in interpret mode (exact=True), as
tests/test_pallas_warp.py runs them, and to the XLA sampler's autodiff.
Tolerances: K2 1e-5 absolute (f32 sampler, matrix-unit formulation vs
gather; K2m, the serving warp, is held to JAX in tests/test_torch_warp_mesh.py); K1 1 uint8 LSB (rounding of coordinates that differ in the last
bits: the Pallas kernel converts NDC to pixels before the map up-sample, the
port after it); K3 0 (both sample full-resolution maps); K4 and K5 2e-6
absolute (the same sums in another order); K6 1e-4 (derivatives of
magnitude ~50, as tests/test_pallas_warp.py:233).

The `cuda` tests hold each kernel to its plain version on a card; they skip
without one.  On a machine with a card and no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops.resize import resize_bilinear_bhw
from stabnet_tpu_torch.ops.warp import mesh_tables

torch.set_num_threads(1)


def _jax():
    """The JAX package's Pallas kernels (the machine with a card has no JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from stabnet_tpu.ops import pallas_warp

    return jnp, pallas_warp


def _integer_and_shifted_maps(B, H, W, shift):
    """Maps whose samples sit on integer pixels (the last column at exactly
    W-1, the last row at exactly H-1) plus a fractional shift; H and W are
    powers of two, so the NDC values are exact."""
    xs = np.arange(W, dtype=np.float32) + shift
    ys = np.arange(H, dtype=np.float32) + shift / 2
    px, py = np.meshgrid(xs, ys)
    x = np.broadcast_to(px * 2 / W - 1, (B, H, W)).astype(np.float32)
    y = np.broadcast_to(py * 2 / H - 1, (B, H, W)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("strict_edge", [True, False])
def test_k2_plain_matches_pallas(strict_edge):
    jnp, pallas_warp = _jax()
    rng = np.random.RandomState(0)
    B, H, W, C = 2, 8, 128, 2
    im = rng.rand(B, H, W, C).astype(np.float32)
    for shift in (0.0, 0.375, -0.5):
        x, y = _integer_and_shifted_maps(B, H, W, shift)
        want = np.asarray(pallas_warp.bilinear_sample_pallas(
            jnp.asarray(im), jnp.asarray(x), jnp.asarray(y), y_band=8,
            x_band=128, interpret=True, exact=True, strict_edge=strict_edge))
        got = cuda_warp.bilinear_sample(torch.from_numpy(im), torch.from_numpy(x),
                                        torch.from_numpy(y), strict_edge=strict_edge)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        if shift == 0.0:
            # Integer samples: the strict edge is exactly 0, the inclusive
            # edge is the edge pixel itself.
            edge = got.numpy()[:, :, W - 1]
            if strict_edge:
                assert np.all(edge == 0)
            else:
                np.testing.assert_allclose(edge[:, :-1], im[:, :-1, W - 1], atol=1e-6)


def test_k2_plain_matches_pallas_warped_maps():
    jnp, pallas_warp = _jax()
    rng = np.random.RandomState(1)
    B, H, W, C = 1, 120, 192, 2          # not tile multiples
    im = rng.rand(B, H, W, C).astype(np.float32)
    gx = np.linspace(-1, 1, W, dtype=np.float32)
    gy = np.linspace(-1, 1, H, dtype=np.float32)
    xg, yg = np.meshgrid(gx, gy)
    x = (xg * 1.03 + 0.01 + 0.02 * np.sin(yg * 3))[None].astype(np.float32)
    y = (yg * 0.97 - 0.02 + 0.02 * np.cos(xg * 2))[None].astype(np.float32)
    want = np.asarray(pallas_warp.bilinear_sample_pallas(
        jnp.asarray(im), jnp.asarray(x), jnp.asarray(y), y_band=32,
        x_band=128, interpret=True, exact=True))
    got = cuda_warp.bilinear_sample(torch.from_numpy(im), torch.from_numpy(x),
                                    torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got == 0).any() and np.abs(got).max() > 0.5  # border band reached


@pytest.mark.parametrize("out_hw", [(110, 180), (120, 192)])  # ragged / exact
def test_k1_plain_matches_pallas(out_hw):
    jnp, pallas_warp = _jax()
    rng = np.random.RandomState(5)
    B, H, W = 2, 120, 192
    h, w = 24, 48
    im = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    gx = np.linspace(-1, 1, w, dtype=np.float32)
    gy = np.linspace(-1, 1, h, dtype=np.float32)
    xg, yg = np.meshgrid(gx, gy)
    x = np.stack([xg * 0.93 - 0.02 + 0.03 * np.sin(yg * 2 + b)
                  for b in range(B)]).astype(np.float32)
    y = np.stack([yg * 0.9 + 0.01 + 0.02 * np.cos(xg * 3 + b)
                  for b in range(B)]).astype(np.float32)
    imc = np.ascontiguousarray(np.moveaxis(im, -1, 1))
    want = np.asarray(pallas_warp.warp_uint8_cf_lowres(
        jnp.asarray(imc), jnp.asarray(x), jnp.asarray(y), out_hw, y_band=32,
        x_band=128, interpret=True, exact=True))
    got = cuda_warp.warp_uint8_cf_lowres(torch.from_numpy(imc), torch.from_numpy(x),
                                         torch.from_numpy(y), out_hw).numpy()
    assert got.shape == (B,) + out_hw + (3,) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


def test_k3_plain_matches_pallas():
    """tests/test_pallas_warp.py:115-136: a size that is not tile-aligned;
    K3 on the CPU equals the Pallas kernel (interpret mode, exact=True) and
    the XLA sampler rounded to uint8, bit for bit."""
    jnp, pallas_warp = _jax()
    from stabnet_tpu.ops.warp import bilinear_sample

    rng = np.random.RandomState(4)
    B, H, W, C = 1, 120, 192, 3
    im = rng.randint(0, 256, (B, H, W, C), dtype=np.uint8)
    gx = np.linspace(-1, 1, W, dtype=np.float32)
    gy = np.linspace(-1, 1, H, dtype=np.float32)
    xg, yg = np.meshgrid(gx, gy)
    xm = (xg * 0.93 - 0.02)[None].astype(np.float32)
    ym = (yg * 0.93 + 0.01)[None].astype(np.float32)
    imc = np.ascontiguousarray(np.moveaxis(im, -1, 1))
    ref = np.asarray(bilinear_sample(jnp.asarray(im, jnp.float32),
                                     jnp.asarray(xm), jnp.asarray(ym)))
    ref_u8 = np.clip(np.round(ref), 0, 255).astype(np.uint8)
    pallas = np.asarray(pallas_warp.warp_uint8_cf(
        jnp.asarray(imc), jnp.asarray(xm), jnp.asarray(ym), y_band=32,
        x_band=128, interpret=True, exact=True))
    got = cuda_warp.warp_uint8_cf(torch.from_numpy(imc), torch.from_numpy(xm),
                                  torch.from_numpy(ym)).numpy()
    assert got.shape == (B, H, W, C) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref_u8)


def test_cpu_tensors_never_count_a_launch():
    rng = np.random.RandomState(2)
    im = torch.from_numpy(rng.rand(1, 8, 16, 1).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 16)).astype(np.float32))
    imc = torch.from_numpy(rng.randint(0, 256, (1, 3, 8, 16), dtype=np.uint8))
    before = [k.launches for k in cuda_warp.KERNELS]
    cuda_warp.bilinear_sample(im, x, x)
    cuda_warp.warp_uint8_cf_lowres(imc, x[:, :2, :4].contiguous(),
                                   x[:, :2, :4].contiguous(), (8, 16))
    cuda_warp.warp_uint8_cf(imc, x, x)
    cuda_warp.bilinear_splat(im, x, x, (6, 10))
    cuda_warp.sample_map_grad(im, x, x, im)
    cuda_warp.warp_mesh(im, torch.eye(3).expand(1, 2, 2, 3, 3).contiguous(),
                        mesh_tables(8, 16, 2, 2, im.device))
    assert [k.launches for k in cuda_warp.KERNELS] == before
    with pytest.raises(ValueError):        # mixed devices are refused
        cuda_warp.bilinear_sample(im.to("meta"), x, x)


def _grad_inputs(device="meta"):
    im = torch.zeros((1, 8, 16, 1), device=device)
    x = torch.zeros((1, 8, 16), device=device)
    imc = torch.zeros((1, 3, 8, 16), dtype=torch.uint8, device=device)
    return im, x, imc


KERNEL_CALLS = {
    "bilinear_sample": lambda im, x, imc: cuda_warp.bilinear_sample(im, x, x),
    "warp_uint8_cf_lowres": lambda im, x, imc: cuda_warp.warp_uint8_cf_lowres(
        imc, x, x, (8, 16)),
    "warp_uint8_cf": lambda im, x, imc: cuda_warp.warp_uint8_cf(imc, x, x),
    "bilinear_splat": lambda im, x, imc: cuda_warp.bilinear_splat(im, x, x, (8, 16)),
    "sample_map_grad": lambda im, x, imc: cuda_warp.sample_map_grad(im, x, x, im),
    "warp_mesh": lambda im, x, imc: cuda_warp.warp_mesh(
        im, torch.zeros((1, 2, 2, 3, 3), device=im.device), mesh_tables(8, 16, 2, 2, im.device)),
}


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_kernels_refuse_inputs_that_require_grad(name, device):
    """No wrapper cuts the autograd graph silently: under grad mode an input
    that requires grad is refused, before any device is touched (the meta
    device stands in for a card), and on the CPU alike."""
    im, x, imc = _grad_inputs(device)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        KERNEL_CALLS[name](im.requires_grad_(), x.requires_grad_(), imc)
    with torch.no_grad():                  # no graph: the check lets it pass
        if device == "meta":
            with pytest.raises(ValueError, match="unsupported device"):
                KERNEL_CALLS[name](im, x, imc)
        else:
            KERNEL_CALLS[name](im, x, imc)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


OVERSIZE_CALLS = {
    # 3 x 30000 x 30000 frame elements: past 2^31 within one image.
    "k3 frame": lambda: cuda_warp.warp_uint8_cf(
        _meta(1, 3, 30000, 30000, dtype=torch.uint8), _meta(1, 8, 16), _meta(1, 8, 16)),
    "k1 frame": lambda: cuda_warp.warp_uint8_cf_lowres(
        _meta(1, 3, 30000, 30000, dtype=torch.uint8), _meta(1, 8, 16), _meta(1, 8, 16),
        (8, 16)),
    "k1 output": lambda: cuda_warp.warp_uint8_cf_lowres(
        _meta(1, 3, 8, 16, dtype=torch.uint8), _meta(1, 8, 16), _meta(1, 8, 16),
        (40000, 20000)),
    # One grid layer per image: at most 65535 images.
    "k3 batch": lambda: cuda_warp.warp_uint8_cf(
        _meta(70000, 3, 8, 16, dtype=torch.uint8), _meta(70000, 8, 16),
        _meta(70000, 8, 16)),
    "k4 image": lambda: cuda_warp.bilinear_splat(
        _meta(1, 8, 16, 2), _meta(1, 8, 16), _meta(1, 8, 16), (40000, 40000)),
    "k2 image": lambda: cuda_warp.bilinear_sample(
        _meta(1, 30000, 30000, 3), _meta(1, 8, 16), _meta(1, 8, 16)),
    "k2 output": lambda: cuda_warp.bilinear_sample(
        _meta(1, 8, 16, 3), _meta(1, 40000, 20000), _meta(1, 40000, 20000)),
    "k2 batch": lambda: cuda_warp.bilinear_sample(
        _meta(70000, 8, 16, 1), _meta(70000, 8, 16), _meta(70000, 8, 16)),
    # K2m reads the frame in place: its row stride spans past 2^31.
    "k2m frame": lambda: cuda_warp.warp_mesh(
        torch.empty_strided((1, 8, 16, 1), (2 ** 32, 2 ** 29, 1, 1), device="meta"),
        _meta(1, 4, 4, 3, 3), mesh_tables(8, 16, 4, 4, torch.device("meta"))),
    "k2m batch": lambda: cuda_warp.warp_mesh(
        _meta(70000, 8, 16, 1), _meta(70000, 4, 4, 3, 3),
        mesh_tables(8, 16, 4, 4, torch.device("meta"))),
    # Every kernel floors coordinates exactly only below 2^22 pixels.
    "k2 side": lambda: cuda_warp.bilinear_sample(
        _meta(1, 1, 5_000_000, 1), _meta(1, 8, 16), _meta(1, 8, 16)),
    "k6b side": lambda: cuda_warp.sample_map_grad(
        _meta(1, 5_000_000, 1, 1), _meta(1, 8, 16), _meta(1, 8, 16), _meta(1, 8, 16, 1)),
}


@pytest.mark.parametrize("case", sorted(OVERSIZE_CALLS))
def test_wrappers_refuse_sizes_beyond_32_bit_indexing(case):
    """K1, K2, K2m, K3 and K4 index within one image in 32 bits and put the
    batch on the grid's z axis, and every kernel floors coordinates with a float
    trick exact below 2^22 pixels; the wrappers refuse larger sizes on every
    device, before any is touched (the meta device holds no memory)."""
    with pytest.raises(ValueError, match="32-bit indexing"):
        OVERSIZE_CALLS[case]()


def _splat_case():
    """tests/test_pallas_warp.py:239-258: maps past +/-1, output smaller
    than the image and not a tile multiple."""
    rng = np.random.RandomState(0)
    B, H, W, C = 2, 48, 64, 2
    Ho, Wo = 40, 56
    ys, xs = np.mgrid[0:Ho, 0:Wo].astype(np.float32)
    xm = np.stack([(2 * (xs + rng.randn() * 2) / W - 1) * 1.06
                   for _ in range(B)]).astype(np.float32)
    ym = np.stack([(2 * (ys + rng.randn() * 2) / H - 1) * 1.06
                   for _ in range(B)]).astype(np.float32)
    g = rng.rand(B, Ho, Wo, C).astype(np.float32)
    return g, xm, ym, (H, W)


def test_k4_plain_matches_pallas_and_xla_adjoint():
    jnp, pallas_warp = _jax()
    import jax

    from stabnet_tpu.ops import warp

    g, xm, ym, (H, W) = _splat_case()
    im = jnp.zeros((g.shape[0], H, W, g.shape[-1]), jnp.float32)
    _, vjp = jax.vjp(lambda im_: warp.bilinear_sample(im_, jnp.asarray(xm),
                                                      jnp.asarray(ym)), im)
    xla = np.asarray(vjp(jnp.asarray(g))[0])
    pallas = np.asarray(pallas_warp.bilinear_splat_pallas(
        jnp.asarray(g), jnp.asarray(xm), jnp.asarray(ym), (H, W), interpret=True))
    got = cuda_warp.bilinear_splat(torch.from_numpy(g), torch.from_numpy(xm),
                                   torch.from_numpy(ym), (H, W)).numpy()
    assert got.shape == xla.shape
    np.testing.assert_allclose(got, xla, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-6)


def test_k4_plain_sums_exactly():
    """The fixed-point sums are exact: a sample far outside the frame puts
    large weights of opposite sign on one clamped tap, and they cancel to
    exactly 0; a non-finite cotangent poisons the whole result."""
    g = torch.ones((1, 1, 2, 1))
    x = torch.tensor([[[-3.0, 0.0]]])      # -3: 512 px left of a 256-px frame
    y = torch.zeros((1, 1, 2))
    out = cuda_warp.bilinear_splat_plain(g, x, y, (4, 256))
    assert float(out[0, :, 0].abs().sum()) == 0.0      # the far sample cancels
    assert float(out.sum()) == 1.0                     # the centre one does not
    g[0, 0, 1, 0] = float("inf")
    assert bool(cuda_warp.bilinear_splat_plain(g, x, y, (4, 256)).isnan().all())


def _map_grad_case():
    """tests/test_pallas_warp.py:209-236."""
    rng = np.random.RandomState(3)
    B, H, W, C = 1, 8, 128, 1
    im = rng.rand(B, H, W, C).astype(np.float32)
    gx = np.linspace(-1, 1, W, dtype=np.float32)
    gy = np.linspace(-1, 1, H, dtype=np.float32)
    xg, yg = np.meshgrid(gx, gy)
    xm = (xg * 0.9 + 0.03)[None].astype(np.float32)
    ym = (yg * 0.9 - 0.02)[None].astype(np.float32)
    g = rng.rand(B, H, W, C).astype(np.float32)
    return im, xm, ym, g


def test_k6_map_gradients_match_pallas_and_xla():
    jnp, pallas_warp = _jax()
    import jax

    from stabnet_tpu.ops import warp

    im, xm, ym, g = _map_grad_case()

    def loss(sampler):
        return lambda x, y: jnp.sum(sampler(jnp.asarray(im), x, y) * jnp.asarray(g))

    args = (jnp.asarray(xm), jnp.asarray(ym))
    want_xla = jax.grad(loss(warp.bilinear_sample), argnums=(0, 1))(*args)
    want_pallas = jax.grad(loss(pallas_warp.bilinear_sample_pallas_const_image),
                           argnums=(0, 1))(*args)
    t = [torch.from_numpy(a) for a in (im, xm, ym, g)]
    kernel = cuda_warp.sample_map_grad(*t)
    xr, yr = t[1].clone().requires_grad_(), t[2].clone().requires_grad_()
    (cuda_warp.bilinear_sample_const_image(t[0], xr, yr) * t[3]).sum().backward()
    for got in (kernel, (xr.grad, yr.grad)):
        for a, b, c in zip(got, want_xla, want_pallas):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4, atol=1e-4)
    # K6b's plain version is the autograd of the plain sampler, summed in
    # another order: within f32 rounding of the largest derivative.
    scale = float(kernel[0].abs().max())
    assert scale > 10
    for a, b in zip(kernel, (xr.grad, yr.grad)):
        assert float((a - b).abs().max()) <= 1e-6 * scale


def test_k5_image_gradients_match_pallas_and_xla():
    """tests/test_pallas_warp.py:261-276: the temporal-loss configuration."""
    jnp, pallas_warp = _jax()
    import jax

    from stabnet_tpu.ops import warp

    rng = np.random.RandomState(1)
    B, H, W, C = 2, 48, 64, 1
    im = rng.rand(B, H, W, C).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    xm = (2 * (xs + 1.3) / W - 1)[None].repeat(B, 0)
    ym = (2 * (ys - 0.7) / H - 1)[None].repeat(B, 0)
    want = {name: np.asarray(jax.grad(lambda im_: jnp.sum(jnp.sin(
        fn(im_, jnp.asarray(xm), jnp.asarray(ym)))))(jnp.asarray(im)))
        for name, fn in (("xla", warp.bilinear_sample),
                         ("pallas", pallas_warp.bilinear_sample_pallas_const_maps))}
    imt = torch.from_numpy(im).requires_grad_()
    torch.sin(cuda_warp.bilinear_sample_const_maps(
        imt, torch.from_numpy(xm), torch.from_numpy(ym))).sum().backward()
    for ref in want.values():
        np.testing.assert_allclose(imt.grad.numpy(), ref, rtol=0, atol=2e-6)
    # The splat of the same cotangent gives the same image gradient.
    with torch.no_grad():
        g = torch.cos(cuda_warp.bilinear_sample_plain(imt, torch.from_numpy(xm),
                                                      torch.from_numpy(ym)))
    splat = cuda_warp.bilinear_splat(g, torch.from_numpy(xm), torch.from_numpy(ym), (H, W))
    np.testing.assert_allclose(splat.numpy(), want["xla"], rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    im = torch.rand((2, 72, 136, 1), generator=gen).to(dev)
    x = (torch.rand((2, 72, 136), generator=gen) * 2.4 - 1.2).to(dev)
    y = (torch.rand((2, 72, 136), generator=gen) * 2.4 - 1.2).to(dev)
    # K2 at 1 to 4 channels and at 5 (channels read at run time), maps of a
    # width that is a multiple of 4 (16-byte loads and stores) and not, and
    # maps at an offset that breaks their 16-byte alignment.
    for C in (1, 2, 3, 4, 5):
        img = torch.rand((3, 61, 97, C), generator=gen).to(dev)
        xw, yw = ((torch.rand((2, 72, 137), generator=gen) * 2.4 - 1.2).to(dev)
                  for _ in range(2))
        xf, yf = ((torch.rand((1 + 2 * 72 * 136,), generator=gen) * 2.4 - 1.2).to(dev)
                  for _ in range(2))
        for xm, ym in ((xw[..., :136].contiguous(), yw[..., :136].contiguous()), (xw, yw),
                       (xf[1:].view(2, 72, 136), yf[1:].view(2, 72, 136))):
            for strict in (True, False):
                before = cuda_warp.bilinear_sample.launches
                got = cuda_warp.bilinear_sample(img[:2].contiguous(), xm, ym, strict_edge=strict)
                assert cuda_warp.bilinear_sample.launches == before + 1
                want = cuda_warp.bilinear_sample_plain(img[:2], xm, ym, strict_edge=strict)
                assert torch.equal(got, want)
    # K2m: the frame read in place from a 13-channel stack and copied out,
    # meshes mild and zoomed out, a size that is not a multiple of 4 or of
    # the mesh, and a mesh whose homographies give Z <= 0 somewhere.
    from stabnet_tpu_torch.ops import base_mesh, mesh_to_homographies

    for (H, W), zoom, flip in (((72, 136), 1.0, False), ((75, 131), 1.2, False),
                               ((72, 136), 1.0, True)):
        mesh = torch.from_numpy(base_mesh(4, 4)) * zoom
        mesh = (mesh + 0.1 * torch.randn((2, 5, 5, 2), generator=gen)).to(dev)
        Hs = mesh_to_homographies(mesh, 4, 4)
        if flip:
            Hs[:, 1:3, 1:3, 2] *= -1.0     # Z < 0 in the middle cells
        stack = torch.rand((2, 13, H, W), generator=gen).to(dev).permute(0, 2, 3, 1)
        for frame in (stack[..., 12:13], stack[..., 12:13].contiguous()):
            before = cuda_warp.warp_mesh.launches
            got = cuda_warp.warp_mesh(frame, Hs, mesh_tables(H, W, 4, 4, dev))
            assert cuda_warp.warp_mesh.launches == before + 1
            want = cuda_warp.warp_mesh_plain(frame, Hs, mesh_tables(H, W, 4, 4, dev))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    # K2m at four pixels per thread (a batch past two waves of the card),
    # with a right edge inside a warp's 128 columns, on an 8 x 8 mesh.
    B, H, W = 8, 96, 720
    assert cuda_warp.warp_mesh_pix(B, H, W, 1) == 4
    mesh = torch.from_numpy(base_mesh(8, 8))
    mesh = (mesh + 0.05 * torch.randn((B, 9, 9, 2), generator=gen)).to(dev)
    Hs = mesh_to_homographies(mesh, 8, 8)
    frame = torch.rand((B, 13, H, W), generator=gen).to(dev).permute(0, 2, 3, 1)[..., 12:13]
    got = cuda_warp.warp_mesh(frame, Hs, mesh_tables(H, W, 8, 8, dev))
    want = cuda_warp.warp_mesh_plain(frame, Hs, mesh_tables(H, W, 8, 8, dev))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    imc = torch.randint(0, 256, (2, 3, 181, 243), generator=gen,
                        dtype=torch.uint8).to(dev)
    xs = resize_bilinear_bhw(x, (18, 34)).contiguous()
    ys = resize_bilinear_bhw(y, (18, 34)).contiguous()
    # K1 at a ragged size, from maps whose row pass a tile stages in shared
    # memory (18 x 34) and from maps too wide for that (72 x 136).
    for xl, yl in ((xs, ys), (x, y)):
        before = cuda_warp.warp_uint8_cf_lowres.launches
        got = cuda_warp.warp_uint8_cf_lowres(imc, xl, yl, (181, 243))
        assert cuda_warp.warp_uint8_cf_lowres.launches == before + 1
        assert torch.equal(got, cuda_warp.warp_uint8_cf_lowres_plain(imc, xl, yl, (181, 243)))
    with pytest.raises(ValueError):        # the wrapper refuses what K1 does not take
        cuda_warp.warp_uint8_cf_lowres(imc.float(), xs, ys, (181, 243))
    # K3 at full-resolution maps of a ragged size: near-identity, random and
    # zoomed-out maps.
    xf = resize_bilinear_bhw(xs, (181, 243)).contiguous()
    yf = resize_bilinear_bhw(ys, (181, 243)).contiguous()
    near_xf = ((torch.arange(243, device=dev) + 0.5) * (2 / 243) - 1 + 0.01 * xf).contiguous()
    near_yf = ((torch.arange(181, device=dev)[:, None] + 0.5) * (2 / 181) - 1
               + 0.01 * yf).contiguous()
    for xm, ym in ((near_xf, near_yf), (xf, yf), (xf * 3.0, yf * 3.0)):
        before = cuda_warp.warp_uint8_cf.launches
        got = cuda_warp.warp_uint8_cf(imc, xm, ym)
        assert cuda_warp.warp_uint8_cf.launches == before + 1
        assert torch.equal(got, cuda_warp.warp_uint8_cf_plain(imc, xm, ym))
    # K4 where every 32 x 32 tile's window fits shared memory (near-identity
    # maps), where none does (uniform random maps), and half and half.
    g = torch.rand((2, 72, 136, 2), generator=gen).to(dev)
    ident_x = (torch.arange(136, device=dev) + 0.5) * (2 / 136) - 1
    ident_y = (torch.arange(72, device=dev) + 0.5) * (2 / 72) - 1
    near_x = (ident_x[None, None, :] + 0.01 * (x - x.mean())).contiguous()
    near_y = (ident_y[None, :, None] + 0.01 * (y - y.mean())).contiguous()
    half = torch.arange(136, device=dev) < 64
    for xm, ym in ((near_x, near_y), (x, y),
                   (torch.where(half, near_x, x), torch.where(half, near_y, y))):
        before = cuda_warp.bilinear_splat.launches
        got = cuda_warp.bilinear_splat(g, xm, ym, (72, 136))
        assert cuda_warp.bilinear_splat.launches == before + 1
        assert torch.equal(got, cuda_warp.bilinear_splat_plain(g, xm, ym, (72, 136)))
        assert torch.equal(got, cuda_warp.bilinear_splat(g, xm, ym, (72, 136)))
    got = cuda_warp.bilinear_splat(g, x, y, (61, 97))
    assert torch.equal(got, cuda_warp.bilinear_splat_plain(g, x, y, (61, 97)))
    assert torch.equal(got, cuda_warp.bilinear_splat(g, x, y, (61, 97)))  # deterministic
    got = cuda_warp.sample_map_grad(im, x, y, g[..., :1].contiguous())
    want = cuda_warp.sample_map_grad_plain(im, x, y, g[..., :1].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _op_args(device="cpu"):
    """Arguments of each `torch.ops.stabnet` op at a small ragged size,
    seeded with numpy; the mesh op reads its frame in place from a stack."""
    rng = np.random.RandomState(7)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    im = t(rng.rand(2, 9, 14, 2).astype(np.float32))
    x = t(rng.uniform(-1.2, 1.2, (2, 7, 11)).astype(np.float32))
    y = t(rng.uniform(-1.2, 1.2, (2, 7, 11)).astype(np.float32))
    imc = t(rng.randint(0, 256, (2, 3, 9, 14), dtype=np.uint8))
    g = t(rng.rand(2, 7, 11, 2).astype(np.float32))
    stack = t(rng.rand(2, 13, 9, 14).astype(np.float32)).permute(0, 2, 3, 1)
    Hs = (torch.eye(3).expand(2, 2, 2, 3, 3)
          + torch.from_numpy(rng.uniform(-0.05, 0.05, (2, 2, 2, 3, 3)).astype(np.float32)))
    tables = tuple(mesh_tables(9, 14, 2, 2, torch.device(device)))
    return {
        "bilinear_sample": (im, x, y, True),
        "warp_mesh": (stack[..., 12:13], Hs.contiguous().to(device), *tables),
        "warp_uint8_cf_lowres": (imc, x[:, :3, :4].contiguous(), y[:, :3, :4].contiguous(),
                                 [9, 14]),
        "warp_uint8_cf": (imc, x, y),
        "bilinear_splat": (g, x, y, [9, 14]),
        "sample_map_grad": (im, x, y, g),
    }


PLAIN = {
    "bilinear_sample": cuda_warp.bilinear_sample_plain,
    "warp_mesh": lambda im, Hs, *tables: cuda_warp.warp_mesh_plain(im, Hs, tables),
    "warp_uint8_cf_lowres": cuda_warp.warp_uint8_cf_lowres_plain,
    "warp_uint8_cf": cuda_warp.warp_uint8_cf_plain,
    "bilinear_splat": cuda_warp.bilinear_splat_plain,
    "sample_map_grad": cuda_warp.sample_map_grad_plain,
}


def _equal(got, want) -> bool:
    got, want = ((got,), (want,)) if isinstance(got, torch.Tensor) else (got, want)
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_custom_op_opcheck(name):
    """Every kernel entry point is a `torch.ops.stabnet` custom op whose
    schema, fake implementation and dispatch `torch.library.opcheck`
    accepts on CPU tensors, and whose result is its plain version's."""
    args = _op_args()[name]
    op = getattr(torch.ops.stabnet, name)
    torch.library.opcheck(op.default, args)
    assert _equal(op(*args), PLAIN[name](*args))


@pytest.mark.cuda
def test_custom_ops_match_plain_on_the_card():
    """Each op through `torch.ops.stabnet` on CUDA tensors launches its
    kernel once and equals its plain version on the same tensors bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, args in _op_args("cuda").items():
        kernel = getattr(cuda_warp, name)
        before = kernel.launches
        got = getattr(torch.ops.stabnet, name)(*args)
        assert kernel.launches == before + 1, name
        assert _equal(got, PLAIN[name](*args)), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 32), (3, 40, 24), (1, 17, 33), (32, 144, 256)])
def test_tvl1_iterate_matches_plain_on_the_card(shape):
    """K7 (ops/flow.py `tvl1_iterate`), three chained iterations: one launch
    each, bit for bit its plain version on the card and on the CPU; its
    inputs untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stabnet_tpu_torch.ops import flow

    rng = np.random.RandomState(9)
    B, H, W = shape
    cpu = [torch.from_numpy((rng.randn(*s) * k).astype(np.float32))
           for s, k in (((B, 2, H, W), 2.0), ((B, 2, 2, H, W), 0.5), ((B, H, W), 20.0),
                        ((B, H, W), 10.0), ((B, H, W), 10.0))]
    card = [t.cuda() for t in cpu]
    kw = dict(tau=0.25, lam=0.15, theta=0.3)
    got, plain, want = card[:2], card[:2], cpu[:2]
    for _ in range(3):
        before = flow.tvl1_iterate.launches
        got = flow.tvl1_iterate(*got, *card[2:], **kw)
        assert flow.tvl1_iterate.launches == before + 1
        plain = flow.tvl1_iterate_plain(*plain, *card[2:], **kw)
        want = flow.tvl1_iterate_plain(*want, *cpu[2:], **kw)
        assert _equal(got, plain) and _equal(tuple(t.cpu() for t in got), want)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 72, 128), (32, 32, 64), (32, 16, 32), (10, 72, 128),
                                   (10, 32, 64), (3, 70, 100), (1, 37, 45), (2, 5, 7)])
def test_tvl1_iterate_n_matches_chained_k7_on_the_card(shape):
    """K7 on chip (ops/flow.py `tvl1_iterate_n`), 100 iterations in one
    launch: bit for bit 100 chained K7 launches, at 0 iterations a copy of
    its inputs, and bit for bit its plain version on the CPU at 3; its
    inputs untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stabnet_tpu_torch.ops import flow

    rng = np.random.RandomState(11)
    B, H, W = shape
    cpu = [torch.from_numpy((rng.randn(*s) * k).astype(np.float32))
           for s, k in (((B, 2, H, W), 2.0), ((B, 2, 2, H, W), 0.5), ((B, H, W), 20.0),
                        ((B, H, W), 10.0), ((B, H, W), 10.0))]
    card = [t.cuda() for t in cpu]
    kw = dict(tau=0.25, lam=0.15, theta=0.3)
    before = flow.tvl1_iterate_n.launches
    got = flow.tvl1_iterate_n(*card, 100, **kw)
    assert flow.tvl1_iterate_n.launches == before + 1
    want = card[:2]
    for _ in range(100):
        want = flow.tvl1_iterate(*want, *card[2:], **kw)
    assert _equal(got, want)
    assert _equal(flow.tvl1_iterate_n(*card, 0, **kw), tuple(card[:2]))
    three = flow.tvl1_iterate_n(*card, 3, **kw)
    assert _equal(tuple(t.cpu() for t in three), flow.tvl1_iterate_n_plain(*cpu, 3, **kw))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
