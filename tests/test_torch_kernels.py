"""The port's warp kernels (stabnet_tpu_torch/ops/cuda_warp.py).

On the CPU the wrappers run their plain versions; those are held here to the
JAX package's Pallas kernels in interpret mode (exact=True), as
tests/test_pallas_warp.py runs them, and to the XLA sampler's autodiff.
Tolerances: K2 1e-5 absolute (f32 sampler, matrix-unit formulation vs
gather); K1 1 uint8 LSB (rounding of coordinates that differ in the last
bits: the Pallas kernel converts NDC to pixels before the map up-sample, the
port after it); K4 and K5 2e-6 absolute (the same sums in another order);
K6 1e-4 (derivatives of magnitude ~50, as tests/test_pallas_warp.py:233).

The `cuda` tests hold each kernel to its plain version on a card; they skip
without one.  On a machine with a card and no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops.resize import resize_bilinear_bhw

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


def test_cpu_tensors_never_count_a_launch():
    rng = np.random.RandomState(2)
    im = torch.from_numpy(rng.rand(1, 8, 16, 1).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 16)).astype(np.float32))
    imc = torch.from_numpy(rng.randint(0, 256, (1, 3, 8, 16), dtype=np.uint8))
    before = [k.launches for k in cuda_warp.KERNELS]
    cuda_warp.bilinear_sample(im, x, x)
    cuda_warp.warp_uint8_cf_lowres(imc, x[:, :2, :4].contiguous(),
                                   x[:, :2, :4].contiguous(), (8, 16))
    cuda_warp.bilinear_splat(im, x, x, (6, 10))
    cuda_warp.sample_map_grad(im, x, x, im)
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
    "bilinear_splat": lambda im, x, imc: cuda_warp.bilinear_splat(im, x, x, (8, 16)),
    "sample_map_grad": lambda im, x, imc: cuda_warp.sample_map_grad(im, x, x, im),
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
    for strict in (True, False):
        before = cuda_warp.bilinear_sample.launches
        got = cuda_warp.bilinear_sample(im, x, y, strict_edge=strict)
        assert cuda_warp.bilinear_sample.launches == before + 1
        want = cuda_warp.bilinear_sample_plain(im, x, y, strict_edge=strict)
        assert float((got - want).abs().max()) <= 1e-5
    imc = torch.randint(0, 256, (2, 3, 181, 243), generator=gen,
                        dtype=torch.uint8).to(dev)
    xs = resize_bilinear_bhw(x, (18, 34)).contiguous()
    ys = resize_bilinear_bhw(y, (18, 34)).contiguous()
    got = cuda_warp.warp_uint8_cf_lowres(imc, xs, ys, (181, 243))
    want = cuda_warp.warp_uint8_cf_lowres_plain(imc, xs, ys, (181, 243))
    assert int((got.int() - want.int()).abs().max()) <= 1
    with pytest.raises(ValueError):        # the wrapper refuses what K1 does not take
        cuda_warp.warp_uint8_cf_lowres(imc.float(), xs, ys, (181, 243))
    g = torch.rand((2, 72, 136, 2), generator=gen).to(dev)
    before = cuda_warp.bilinear_splat.launches
    got = cuda_warp.bilinear_splat(g, x, y, (61, 97))
    assert cuda_warp.bilinear_splat.launches == before + 1
    assert torch.equal(got, cuda_warp.bilinear_splat_plain(g, x, y, (61, 97)))
    assert torch.equal(got, cuda_warp.bilinear_splat(g, x, y, (61, 97)))  # deterministic
    got = cuda_warp.sample_map_grad(im, x, y, g[..., :1].contiguous())
    want = cuda_warp.sample_map_grad_plain(im, x, y, g[..., :1].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
