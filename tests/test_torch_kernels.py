"""The port's warp kernels K1 and K2 (stabnet_tpu_torch/ops/cuda_warp.py).

On the CPU the wrappers run their plain versions; those are held here to the
JAX package's Pallas kernels in interpret mode (exact=True), as
tests/test_pallas_warp.py runs them.  Tolerances: K2 1e-5 absolute (f32
sampler, matrix-unit formulation vs gather); K1 1 uint8 LSB (rounding of
coordinates that differ in the last bits: the Pallas kernel converts NDC to
pixels before the map up-sample, the port after it).

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
    assert [k.launches for k in cuda_warp.KERNELS] == before
    with pytest.raises(ValueError):        # mixed devices are refused
        cuda_warp.bilinear_sample(im.to("meta"), x, x)


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
