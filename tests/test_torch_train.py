"""The port's training path against the JAX package, on the CPU.

Same seeded numpy inputs through both packages.  Tolerances:
  * each loss term: 1e-6 relative (the same f32 formulas, summed in another
    order by another library);
  * one TINY Siamese step of a narrow trunk in f32 from the same weights
    and the same augmented batch, against JAX `compute_losses` with the XLA
    warp: every loss term 1e-5 relative; gradients 1e-4 of each leaf's max
    (a conv bias read only through BatchNorms has a zero gradient in exact
    arithmetic: both packages must give noise below 1e-6 of the model's
    largest gradient there); the new BN statistics 1e-6 absolute;
  * Adam fed the JAX gradients: the update 1e-7 of each leaf's max update
    against optax (the same formula, rounded in the same order).
"""

import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stabnet_tpu import losses as jax_losses
from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.data import augment_batch as jax_augment_batch
from stabnet_tpu.data import make_raw_batch as jax_make_raw_batch
from stabnet_tpu.data import prepare_raw as jax_prepare_raw
from stabnet_tpu.models.resnet import ResNetV2 as JaxResNetV2
from stabnet_tpu.models.resnet import ThetaHead as JaxThetaHead
from stabnet_tpu.train.state import lr_schedule as jax_lr_schedule
from stabnet_tpu.train.state import make_optimizer as jax_make_optimizer
from stabnet_tpu.train.train import compute_losses as jax_compute_losses
from stabnet_tpu.train.train import loss_gates as jax_loss_gates
from stabnet_tpu_torch import losses
from stabnet_tpu_torch.config import apply_overrides, get_config
from stabnet_tpu_torch.models import convert_flax_variables, make_model
from stabnet_tpu_torch.models.resnet import ResNetV2, StabNetRegressor, cast_weights
from stabnet_tpu_torch.ops import cell_pts
from stabnet_tpu_torch.train import (Adam, TrainState, compute_losses,
                                     create_train_state, eval_step, learning_rate,
                                     loss_gates, train_step)

torch.set_num_threads(1)

NARROW = dict(stage_sizes=(2, 1, 1, 1),
              stage_depths=((32, 8), (64, 16), (128, 32), (256, 64)))
LIVE = dict(compute_dtype="float32", do_temp_loss_iter=0, do_black_loss_iter=0,
            do_theta_only_iter=-1)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- losses -------------------------------------------------------------------

def _mesh(rng, B=3, scale=0.3):
    base = np.stack(np.meshgrid(np.linspace(-1, 1, 5, dtype=np.float32),
                                np.linspace(-1, 1, 5, dtype=np.float32)), axis=-1)
    return (base[None] + rng.uniform(-scale, scale, (B, 5, 5, 2))).astype(np.float32)


def _loss_inputs():
    rng = np.random.RandomState(4)
    mesh = _mesh(rng)
    B, H, W, N = 3, 12, 20, 16
    return {
        "theta": rng.randn(B, 50).astype(np.float32) * 0.1,
        "mesh": mesh, "pts1": cell_pts(_t(mesh)).numpy(),
        "matches": rng.uniform(-1.1, 1.1, (B, N, 4)).astype(np.float32),
        "mask": (rng.rand(B, N) > 0.3).astype(np.float32),
        "x_map": rng.uniform(-1.2, 1.2, (B, H, W)).astype(np.float32),
        "y_map": rng.uniform(-1.2, 1.2, (B, H, W)).astype(np.float32),
        "out": rng.uniform(-0.5, 0.5, (B, H, W, 1)).astype(np.float32),
        "y": rng.uniform(-0.5, 0.5, (B, H, W, 1)).astype(np.float32),
        "black": (rng.rand(B, H, W) > 0.8).astype(np.float32),
        "noblack": rng.rand(B, H, W, 1).astype(np.float32),
    }


LOSS_CASES = {
    "id_loss": lambda m, a: m.id_loss(a["theta"]),
    "black_pos_loss": lambda m, a: m.black_pos_loss(a["pts1"], 0.8),
    "distortion_loss": lambda m, a: m.distortion_loss(a["pts1"], 4, 4),
    "consistency_loss": lambda m, a: m.consistency_loss(a["mesh"]),
    "warp_pts": lambda m, a: m.warp_pts(a["matches"][..., :2], a["x_map"], a["y_map"]),
    "feature_loss": lambda m, a: m.feature_loss(a["matches"], a["mask"], a["x_map"],
                                                a["y_map"]),
    "masked_mse": lambda m, a: m.masked_mse(a["out"] - a["y"], a["noblack"]),
    "img_loss": lambda m, a: m.img_loss(a["out"], a["y"], a["black"]),
    "temporal_loss": lambda m, a: m.temporal_loss(a["out"], a["black"], a["y"],
                                                  a["noblack"]),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_term_matches_jax(name):
    inputs = _loss_inputs()
    want = np.asarray(LOSS_CASES[name](jax_losses, {k: jnp.asarray(v)
                                                    for k, v in inputs.items()}))
    got = LOSS_CASES[name](losses, {k: _t(v) for k, v in inputs.items()}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.abs(want).max() > 0


def test_black_pos_loss_live():
    inputs = _loss_inputs()
    assert float(losses.black_pos_loss(_t(inputs["pts1"]), 0.8)) > 0


@functools.lru_cache(maxsize=None)
def _tiny_variables():
    cfg = jax_config("tiny").replace(compute_dtype="float32")
    model = _JaxNarrow(cfg.theta_dim)
    x = jnp.zeros((1, cfg.height, cfg.width, cfg.in_channels))
    v = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(1), x))
    # Production-size warps: the random head emits O(1) mesh offsets.
    v["params"]["head"]["out"] = {k: a * 0.05 for k, a in v["params"]["head"]["out"].items()}
    return v


def _port_narrow(cfg):
    model = StabNetRegressor(cfg.in_channels, cfg.theta_dim, dtype=torch.float32,
                             **NARROW)
    model.load_state_dict(convert_flax_variables(_tiny_variables()))
    return model


def test_l2_regularization_counts_conv_and_dense_kernels_only():
    cfg = get_config("tiny")
    model = _port_narrow(cfg)
    want = float(jax_losses.l2_regularization(
        jax.tree_util.tree_map(jnp.asarray, _tiny_variables()["params"]),
        cfg.weight_decay, cfg.head_weight_decay))
    got = float(losses.l2_regularization(model, cfg.weight_decay,
                                         cfg.head_weight_decay).detach())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # By hand: kernels only, head.out at 2e-4; BN scales (also named
    # `weight`) and every bias left out.
    by_hand = 0.0
    for name, p in model.named_parameters():
        if name.endswith(".weight") and "bn" not in name and "postnorm" not in name:
            by_hand += (2e-4 if name.startswith("head.out") else 1e-4) * float(
                p.detach().double().square().sum())
    np.testing.assert_allclose(got, 0.5 * by_hand, rtol=1e-6)


# --- schedule ------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 99, 100, 101, 999, 1000, 4999, 5000, 40000, 10 ** 6 + 1])
def test_loss_gates_match_jax(step):
    cfg = get_config("v2_93")
    want = {k: float(v) for k, v in jax_loss_gates(jnp.asarray(step), jax_config("v2_93")).items()}
    assert loss_gates(step, cfg) == want


@pytest.mark.parametrize("step", [0, 1, 39999, 40000, 80001])
def test_learning_rate_matches_optax(step):
    want = float(jax_lr_schedule(jax_config("v2_93"))(step))
    assert learning_rate(step, get_config("v2_93")) == want


# --- the Siamese step ------------------------------------------------------------

class _JaxNarrow(nn.Module):
    """The JAX package's trunk at NARROW widths plus its theta head."""

    theta_dim: int = 50

    @nn.compact
    def __call__(self, x, train: bool = False):
        feats = JaxResNetV2(dtype=jnp.float32, name="resnet_v2_50", **NARROW)(x, train=train)
        return JaxThetaHead(self.theta_dim, dtype=jnp.float32, name="head")(feats)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX loss terms, gradients, new BN statistics and the optax update of
    one TINY step (all losses live) on the augmented batch of seed 0."""
    cfg = jax_config("tiny").replace(**LIVE)
    raw = jax_prepare_raw(jax_make_raw_batch(cfg, 2, seed=0))
    batch = {k: np.asarray(v) for k, v in
             jax_augment_batch(jax.random.PRNGKey(0), raw, cfg).items()}
    model, variables = _JaxNarrow(cfg.theta_dim), _tiny_variables()
    gates = jax_loss_gates(jnp.asarray(0), cfg)

    @jax.jit
    def step(params, stats, b):
        def loss_fn(p):
            return jax_compute_losses(model, p, stats, b, cfg, gates, pallas_warp=False)
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, (aux, new_stats) = step(variables["params"], variables["batch_stats"], batch)
    tx = jax_make_optimizer(cfg)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return batch, {k: float(v) for k, v in aux.items()}, as_np(grads), \
        as_np(new_stats), as_np(updates)


@functools.lru_cache(maxsize=None)
def _port_step():
    cfg = get_config("tiny").replace(**LIVE)
    batch = {k: _t(v) for k, v in _jax_step()[0].items()}
    model = _port_narrow(cfg).train()
    total, aux = compute_losses(model, batch, cfg, loss_gates(0, cfg))
    total.backward()
    return model, {k: float(v.detach()) for k, v in aux.items()}


def test_tiny_step_loss_terms_match_jax():
    _, want, _, _, _ = _jax_step()
    _, got = _port_step()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    assert want["temp"] > 0 and want["feature1"] > 0   # every term live


# Biases whose output reaches the loss only through BatchNorms (the stem,
# each unit's conv3 and shortcut conv feed the residual stream, which only
# BatchNorms read): their exact gradient is zero.
ZERO_GRAD = ("conv1.conv.bias", "conv3.bias", "shortcut_conv.bias")


def test_tiny_step_gradients_match_jax():
    want = convert_flax_variables({"params": _jax_step()[2]})
    model, _ = _port_step()
    gmax = max(float(v.abs().max()) for v in want.values())
    for name, p in model.named_parameters():
        ref = want[name]
        if name.endswith(ZERO_GRAD):
            # Both are rounding noise around the exact zero.
            assert max(float(ref.abs().max()), float(p.grad.abs().max())) <= 1e-6 * gmax
            continue
        err = float((p.grad - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (name, err)


def test_tiny_step_bn_statistics_match_jax():
    want = convert_flax_variables({"batch_stats": _jax_step()[3]})
    model, _ = _port_step()
    state = model.state_dict()
    start = convert_flax_variables({"batch_stats": _tiny_variables()["batch_stats"]})
    for name, ref in want.items():
        np.testing.assert_allclose(state[name].numpy(), ref.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        assert not torch.equal(state[name], start[name])    # the step moved them


def test_adam_update_matches_optax():
    """The JAX gradients through the port's optimizer: with the parameters
    at 0, one step leaves exactly the update in them."""
    _, _, grads, _, updates = _jax_step()
    grads = convert_flax_variables({"params": grads})
    want = convert_flax_variables({"params": updates})
    model = _port_narrow(get_config("tiny"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.zero_()
            p.grad = grads[name].clone()
    Adam(model.parameters()).step(learning_rate(0, get_config("tiny")))
    for name, p in model.named_parameters():
        ref = want[name]
        err = float((p.detach() - ref).abs().max())
        assert err <= 1e-7 * float(ref.abs().max()), (name, err)


# --- BatchNorm's training branch and the fp32 parameters ------------------------

def test_narrow_trunk_train_mode_matches_flax():
    """Training-mode BN: biased batch variance, ra <- 0.997 ra + 0.003 batch."""
    rng = np.random.RandomState(2)
    flax_trunk = JaxResNetV2(dtype=jnp.float32, **NARROW)
    x = rng.uniform(-1, 1, (3, 44, 60, 13)).astype(np.float32)
    variables = flax_trunk.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    want, new = flax_trunk.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    trunk = ResNetV2(13, dtype=torch.float32, **NARROW).train()
    trunk.load_state_dict(convert_flax_variables(variables))
    got = trunk(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    state = trunk.state_dict()
    for name, ref in convert_flax_variables(new).items():
        np.testing.assert_allclose(state[name].numpy(), ref.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_parameters_are_fp32_and_serving_cast_changes_no_output():
    """bf16 compute with fp32 parameters cast at each use gives the outputs
    of the same model with its weights stored in bf16 (the engine's
    `cast_weights`), bit for bit."""
    cfg = get_config("tiny")
    model = make_model(cfg, torch.Generator().manual_seed(3))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    x = _t(np.random.RandomState(1).uniform(-0.5, 0.5, (2, cfg.height, cfg.width,
                                                        cfg.in_channels)).astype(np.float32))
    with torch.inference_mode():
        before = model(x)
        cast_weights(model)
        after = model(x)
    assert model.head.fc1.weight.dtype == torch.bfloat16
    assert model.head.out.weight.dtype == torch.float32      # the fp32 head stays
    assert model.resnet_v2_50.postnorm.weight.dtype == torch.float32
    assert torch.equal(before, after)


# --- state, step, checkpoint, loop and CLI --------------------------------------

def test_train_state_defaults_to_cuda():
    cfg = get_config("tiny")
    state = create_train_state(cfg, device="cpu", seed=2)
    assert state.step == 0 and state.opt.count == 0 and state.model.training
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in state.model.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_train_state(cfg)


def _narrow_state(cfg):
    model = _port_narrow(cfg).train()
    return TrainState(step=0, model=model, opt=Adam(model.parameters()))


def _tiny_batch(cfg, seed=0):
    from stabnet_tpu_torch.data import augment_batch, make_raw_batch, prepare_raw

    raw = prepare_raw(make_raw_batch(cfg, cfg.batch_size, seed=seed))
    return augment_batch(torch.Generator().manual_seed(seed),
                         {k: _t(v) for k, v in raw.items()}, cfg)


def test_train_step_updates_and_eval_step_freezes():
    cfg = get_config("tiny").replace(**LIVE)
    state = _narrow_state(cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = _tiny_batch(cfg)
    ev = eval_step(state, batch, cfg)
    assert np.isfinite(float(ev["total"]))
    assert all(torch.equal(before[k], v) for k, v in state.model.state_dict().items())
    state, aux = train_step(state, batch, cfg)
    assert state.step == 1 and state.opt.count == 1 and state.model.training
    after = state.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in after
               if k.endswith(("running_mean", "running_var", "conv.weight")))
    assert np.isfinite(float(aux["total"]))


def test_checkpoint_round_trip(tmp_path):
    from stabnet_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("tiny").replace(**LIVE)
    state = _narrow_state(cfg)
    state, _ = train_step(state, _tiny_batch(cfg), cfg)
    ckpt.save(str(tmp_path), state)
    assert ckpt.latest_step(str(tmp_path)) == 1
    fresh = ckpt.restore(str(tmp_path), _narrow_state(cfg))
    assert fresh.step == 1 and fresh.opt.count == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for a, b in zip(state.opt.mu + state.opt.nu, fresh.opt.mu + fresh.opt.nu):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), fresh)


def test_cli_train_then_restore(tmp_path):
    """`train --steps 1`, then `--restore --steps 2`: the run ends at step 2
    with a checkpoint and the JSONL metrics (as tests/test_train.py:168-186
    holds the JAX loop)."""
    import json

    from stabnet_tpu_torch.cli.main import main
    from stabnet_tpu_torch.train import checkpoint as ckpt

    data, models, log = (str(tmp_path / d) for d in ("data", "models", "log"))
    main(["make-synthetic", "--out", os.path.join(data, "train"), "--num", "4",
          "--config", "tiny", "--seed", "3"])
    base = ["train", "--config", "tiny", "--data", data, "--model-dir", models,
            "--log-dir", log, "--device", "cpu", "--set", "compute_dtype=float32"]
    main(base + ["--steps", "1"])
    assert ckpt.latest_step(models) == 1
    main(base + ["--steps", "2", "--restore"])
    assert ckpt.latest_step(models) == 2
    with open(os.path.join(log, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["total"]) and r["step_ms"] > 0 for r in rows)


def test_metrics_writer_tensorboard(tmp_path):
    tb = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    from stabnet_tpu_torch.train.loop import MetricsWriter

    w = MetricsWriter(str(tmp_path), tensorboard=True)
    w.write(7, "train", {"total": 0.5})
    w.close()
    acc = tb.EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert acc.Scalars("train/total")[0].value == 0.5
    assert (tmp_path / "metrics.jsonl").exists()


def test_config_set_overrides():
    cfg = apply_overrides(get_config("tiny"), ["step_size=4000", "initial_learning_rate=1e-4",
                                               "name=endur", "indices=0,1,2,3",
                                               "input_mask=no"])
    assert cfg.step_size == 4000 and isinstance(cfg.step_size, int)
    assert cfg.initial_learning_rate == 1e-4 and cfg.name == "endur"
    assert cfg.indices == (0, 1, 2, 3) and cfg.input_mask is False
    with pytest.raises(KeyError):
        apply_overrides(cfg, ["no_such_field=1"])
    with pytest.raises(ValueError):
        apply_overrides(cfg, ["step_size"])
