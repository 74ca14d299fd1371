"""The port's ResNet-v2 regressor against the JAX package's Flax model.

Weights come from the JAX package's own initialisers and reach the port
through `convert_flax_variables`; the inputs are seeded numpy arrays.
Tolerances: the narrow trunk's features 1e-4 and TINY's theta 1e-5 absolute
in f32 (convolutions summed in another order by another library); bf16
theta < 0.05, the bound of tests/test_parity_strict.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.models import init_variables, make_model as jax_make_model
from stabnet_tpu.models.resnet import ResNetV2 as JaxResNetV2
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.models import convert_flax_variables, make_model
from stabnet_tpu_torch.models.resnet import ResNetV2

torch.set_num_threads(1)

NARROW = dict(stage_sizes=(2, 1, 1, 1),
              stage_depths=((32, 8), (64, 16), (128, 32), (256, 64)))


def _perturb_bn(variables, rng):
    """Random BN statistics, scales and biases, so BN is not the identity."""
    def leaf(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "mean" or (name == "bias" and "bn" in str(path[-2].key)):
            return rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, variables)


def test_narrow_trunk_matches_flax_f32():
    """1 unit per stage except a strided 2-unit first block (the subsample
    shortcut), odd feature sizes (TF "SAME" max-pool pads (0, 1))."""
    rng = np.random.RandomState(0)
    flax_trunk = JaxResNetV2(dtype=jnp.float32, **NARROW)
    x = rng.uniform(-1, 1, (2, 44, 60, 13)).astype(np.float32)
    variables = flax_trunk.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    variables = _perturb_bn(variables, rng)
    want = np.asarray(flax_trunk.apply(variables, jnp.asarray(x), train=False))

    trunk = ResNetV2(13, dtype=torch.float32, **NARROW).eval()
    trunk.load_state_dict(convert_flax_variables(variables))
    with torch.inference_mode():
        got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2, 2, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _tiny_variables():
    """Flax variables of TINY (fp32 parameters under either compute dtype)."""
    jcfg = jax_config("tiny")
    return init_variables(jax_make_model(jcfg), jcfg, jax.random.PRNGKey(7))


def _theta_pair(compute_dtype):
    cfg = get_config("tiny").replace(compute_dtype=compute_dtype)
    jmodel = jax_make_model(jax_config("tiny").replace(compute_dtype=compute_dtype))
    variables = _tiny_variables()
    x = np.random.RandomState(3).uniform(
        -0.5, 0.5, (2, cfg.height, cfg.width, cfg.in_channels)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = make_model(cfg)
    model.load_state_dict(convert_flax_variables(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5),
                                               ("bfloat16", 0.05)])
def test_tiny_regressor_theta_matches_flax(compute_dtype, tol):
    got, want = _theta_pair(compute_dtype)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 50)
    assert np.abs(want).max() > 0.1      # a live head, not all zeros
    assert np.abs(got - want).max() < tol, np.abs(got - want).max()
