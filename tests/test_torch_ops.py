"""Geometry ops of the PyTorch port against the JAX package and the NumPy oracle.

Every test feeds the same seeded numpy inputs to the JAX function and its
port.  Tolerances: resize and mesh 1e-6 absolute (same f32 arithmetic, sums
of two products in another order); solves and homographies 1e-5 relative
(one batched LU solve, LAPACK through two frameworks); dense maps 1e-5
absolute where |map| <= 1.5; samplers 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabnet_tpu.ops import homography as jhom
from stabnet_tpu.ops import mesh as jmesh
from stabnet_tpu.ops import resize as jresize
from stabnet_tpu.ops import warp as jwarp
from stabnet_tpu_torch.ops import homography as thom
from stabnet_tpu_torch.ops import mesh as tmesh
from stabnet_tpu_torch.ops import resize as tresize
from stabnet_tpu_torch.ops import warp as twarp
from tests import reference_impl as ref

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _random_mesh(rng, B, gh=4, gw=4, spread=0.08):
    base = tmesh.base_mesh(gh, gw)
    return (base + rng.uniform(-spread, spread, (B, gh + 1, gw + 1, 2))).astype(np.float32)


def test_resize_matches_jax():
    rng = np.random.RandomState(0)
    for shape_in, shape_out in (((72, 128), (288, 512)),   # color-warp up-sample
                                ((288, 512), (72, 128)),   # map low-pass
                                ((7, 9), (13, 20)),        # non-integer ratios
                                ((720, 1280), (288, 512))):  # device gray
        m = rng.uniform(-1.5, 1.5, (2,) + shape_in).astype(np.float32)
        np.testing.assert_array_equal(
            tresize.resize_matrix(shape_in[0], shape_out[0]),
            jresize.resize_matrix(shape_in[0], shape_out[0]))
        want = np.asarray(jresize.resize_bilinear_bhw(jnp.asarray(m), shape_out))
        got = tresize.resize_bilinear_bhw(_t(m), shape_out).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mesh_matches_jax():
    rng = np.random.RandomState(1)
    theta = rng.uniform(-0.4, 0.4, (3, 50)).astype(np.float32)
    np.testing.assert_array_equal(tmesh.base_mesh(4, 4), jmesh.base_mesh(4, 4))
    want = np.asarray(jmesh.theta_to_mesh(jnp.asarray(theta), 4, 4, 0.8))
    got = tmesh.theta_to_mesh(_t(theta), 4, 4, 0.8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() == pytest.approx(1.25)   # the clamp is exercised
    np.testing.assert_allclose(got[0], ref.ref_theta_to_mesh(theta[0], 4, 4, 0.8),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmesh.cell_pts(_t(got)).numpy(),
                               np.asarray(jmesh.cell_pts(jnp.asarray(got))),
                               rtol=0, atol=1e-6)


def test_homographies_match_jax_and_oracle():
    rng = np.random.RandomState(2)
    mesh = _random_mesh(rng, 3)
    want = np.asarray(jhom.mesh_to_homographies(jnp.asarray(mesh), 4, 4))
    got = thom.mesh_to_homographies(_t(mesh), 4, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], ref.ref_mesh_to_hs(mesh[1], 4, 4),
                               rtol=1e-5, atol=1e-6)

    src = rng.uniform(-1, 1, (5, 4, 2)).astype(np.float32)
    dst = (src + rng.uniform(-0.1, 0.1, src.shape)).astype(np.float32)
    H = thom.solve_dlt(_t(src), _t(dst)).numpy()
    np.testing.assert_allclose(H, np.asarray(jhom.solve_dlt(jnp.asarray(src),
                                                            jnp.asarray(dst))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(H[0], ref.ref_solve_dlt(src[0], dst[0]),
                               rtol=1e-5, atol=1e-6)

    pts = rng.uniform(-1, 1, (5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        thom.apply_homography(_t(H), _t(pts)).numpy(),
        np.asarray(jhom.apply_homography(jnp.asarray(H), jnp.asarray(pts))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(48, 64), (50, 70)])   # blocked / gather branch
def test_dense_maps_and_black_mask_match_jax(hw):
    rng = np.random.RandomState(3)
    Hs = np.asarray(jhom.mesh_to_homographies(
        jnp.asarray(_random_mesh(rng, 2, spread=0.2)), 4, 4))
    jx, jy = (np.asarray(a) for a in jwarp.dense_maps(jnp.asarray(Hs), *hw))
    tx, ty = (a.numpy() for a in twarp.dense_maps(_t(Hs), *hw))
    for got, want in ((tx, jx), (ty, jy)):
        keep = np.abs(want) <= 1.5
        np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-5)
    rx, ry = ref.ref_dense_maps(Hs[0], *hw)
    np.testing.assert_allclose(tx[0], rx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ty[0], ry, rtol=0, atol=1e-5)
    # Same maps in, same mask out.
    np.testing.assert_array_equal(twarp.black_mask(_t(jx), _t(jy)).numpy(),
                                  np.asarray(jwarp.black_mask(jnp.asarray(jx),
                                                              jnp.asarray(jy))))
    assert 0 < twarp.black_mask(_t(tx), _t(ty)).numpy().mean() < 1


def test_bilinear_sample_matches_jax_and_oracle_at_edges():
    """The plain sampler, including samples exactly at 0, W-1 and H-1 (the
    strict edge gives exactly 0), integer coordinates and outside points."""
    rng = np.random.RandomState(4)
    B, H, W, C = 2, 16, 32, 3
    im = rng.uniform(0, 1, (B, H, W, C)).astype(np.float32)
    # Pixel targets, then NDC; H and W are powers of two so these are exact.
    px = rng.uniform(-3, W + 3, (B, 20, 24)).astype(np.float32)
    py = rng.uniform(-3, H + 3, (B, 20, 24)).astype(np.float32)
    px[:, :, 0], px[:, :, 1], px[:, :, 2] = W - 1, 0.0, 5.0
    py[:, 0], py[:, 1], py[:, 2] = H - 1, 0.0, 7.0
    x = (px * 2 / W - 1).astype(np.float32)
    y = (py * 2 / H - 1).astype(np.float32)
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(im), jnp.asarray(x),
                                            jnp.asarray(y)))
    got = twarp.bilinear_sample(_t(im), _t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], ref.ref_bilinear_sample(im[1], x[1], y[1]),
                               rtol=0, atol=1e-5)
    assert np.all(got[:, :, 0] == 0) and np.all(got[:, 0] == 0)   # strict edge
    assert np.abs(got[:, 2:, 2:]).max() > 0.5
