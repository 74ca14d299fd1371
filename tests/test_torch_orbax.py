"""A JAX model directory (Orbax) read by the port through
`scripts/torch_from_orbax.py`.

TINY in f32 with every loss live: the JAX train state (theta head scaled by
0.05, so the warps are of production size) takes one JAX step, is saved by
`stabnet_tpu.train.checkpoint.save` at step 1 and converted; the converted
state equals the Orbax restore bit for bit.  Bounds on the next step, those
tests/test_torch_train.py holds a step to: the port's loss terms on the
restored state within 1e-5 relative of JAX's on its Orbax restore (the full
TINY trunk measured 8.5e-6 at most, on distortion1); its BN statistics
after that forward within 1e-6 (measured 2.4e-7); the restored Adam fed
JAX's gradients of that step, the update within 1e-7 of each leaf's largest
against optax's on the restored optimizer state.  Serving from the two
directories through the two CLIs: every frame within 1 uint8 LSB and the
crop rectangles equal.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from stabnet_tpu import config as jax_config_mod
from stabnet_tpu.cli.main import main as jax_cli
from stabnet_tpu.data import augment_batch as jax_augment_batch
from stabnet_tpu.data import make_raw_batch as jax_make_raw_batch
from stabnet_tpu.data import prepare_raw as jax_prepare_raw
from stabnet_tpu.models import make_model as jax_make_model
from stabnet_tpu.models import scale_theta_head as jax_scale_theta_head
from stabnet_tpu.stream import StreamDriver as JaxStreamDriver
from stabnet_tpu.train import checkpoint as jax_ckpt
from stabnet_tpu.train.state import create_train_state as jax_create_train_state
from stabnet_tpu.train.state import make_optimizer as jax_make_optimizer
from stabnet_tpu.train.train import compute_losses as jax_compute_losses
from stabnet_tpu.train.train import loss_gates as jax_loss_gates
from stabnet_tpu.train.train import make_train_step as jax_make_train_step
from stabnet_tpu_torch import config as config_mod
from stabnet_tpu_torch.cli.main import main as port_cli
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.models import convert_flax_variables
from stabnet_tpu_torch.stream import StreamDriver, video_io
from stabnet_tpu_torch.train import checkpoint as ckpt
from stabnet_tpu_torch.train import compute_losses, create_train_state, learning_rate, loss_gates

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import torch_from_orbax  # noqa: E402

torch.set_num_threads(1)

LIVE = dict(compute_dtype="float32", do_temp_loss_iter=0, do_black_loss_iter=0,
            do_theta_only_iter=-1)
F32 = "tiny_f32"


def _batch(seed):
    cfg = jax_config_mod.get_config("tiny").replace(**LIVE)
    raw = jax_prepare_raw(jax_make_raw_batch(cfg, 2, seed=seed))
    return {k: np.asarray(v) for k, v in
            jax_augment_batch(jax.random.PRNGKey(seed), raw, cfg).items()}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The JAX model directory at step 1 and its conversion."""
    root = tmp_path_factory.mktemp("orbax")
    cfg = jax_config_mod.get_config("tiny").replace(**LIVE)
    model = jax_make_model(cfg)
    state = jax_create_train_state(model, cfg, jax.random.PRNGKey(0))
    state = state.replace(params=jax_scale_theta_head({"params": state.params})["params"])
    state, _ = jax_make_train_step(model, cfg)(state, _batch(0))
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_ckpt.save(jax_dir, state)
    assert torch_from_orbax.main(["--model-dir", jax_dir, "--out", port_dir,
                                  "--config", "tiny"]) == 0
    return jax_dir, port_dir


@functools.lru_cache(maxsize=None)
def _jax_next_step(jax_dir):
    """JAX's loss terms, new BN statistics, gradients and optax update of
    step 2 on the Orbax restore of `jax_dir`."""
    cfg = jax_config_mod.get_config("tiny").replace(**LIVE)
    model = jax_make_model(cfg)
    state = jax_ckpt.restore(jax_dir, jax_create_train_state(model, cfg,
                                                             jax.random.PRNGKey(1)))
    assert int(state.step) == 1
    gates, batch = jax_loss_gates(state.step, cfg), _batch(1)

    def loss_fn(p):
        return jax_compute_losses(model, p, state.batch_stats, batch, cfg, gates,
                                  pallas_warp=False)

    grads, (aux, new_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(state.params)
    updates, _ = jax_make_optimizer(cfg).update(grads, state.opt_state, state.params)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return ({k: float(v) for k, v in aux.items()}, as_np(new_stats), as_np(grads),
            as_np(updates))


def _restored():
    cfg = config_mod.get_config("tiny").replace(**LIVE)
    return cfg, create_train_state(cfg, device="cpu")


def test_converted_state_holds_every_part_of_the_jax_state(dirs):
    jax_dir, port_dir = dirs
    assert ckpt.latest_step(port_dir) == 1
    cfg = jax_config_mod.get_config("tiny")
    want = jax_ckpt.restore(jax_dir, jax_create_train_state(jax_make_model(cfg), cfg,
                                                            jax.random.PRNGKey(1)))
    _, state = _restored()
    ckpt.restore(port_dir, state)
    assert state.step == 1 and state.opt.count == 1
    model_state = state.model.state_dict()
    for name, ref in convert_flax_variables({"params": want.params,
                                             "batch_stats": want.batch_stats}).items():
        assert torch.equal(model_state[name], ref), name
    adam = want.opt_state[0]
    for moments, ref in ((state.opt.mu, adam.mu), (state.opt.nu, adam.nu)):
        ref = convert_flax_variables({"params": ref})
        for (name, _), got in zip(state.model.named_parameters(), moments):
            assert torch.equal(got, ref[name]), name
        assert any(float(m.abs().max()) > 0 for m in moments)


def test_next_step_after_restore_matches_jax(dirs):
    """Step 2 from the converted directory against step 2 from the Orbax
    one: the loss terms and BN statistics of the forward, and the Adam
    update from the restored moments and count."""
    jax_dir, port_dir = dirs
    want_aux, want_stats, grads, updates = _jax_next_step(jax_dir)
    cfg, state = _restored()
    ckpt.restore(port_dir, state)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in _batch(1).items()}
    model = state.model.train()
    _, aux = compute_losses(model, batch, cfg, loss_gates(state.step, cfg))
    assert set(aux) == set(want_aux)
    rel = {k: abs(float(aux[k].detach()) - ref) / abs(ref) if ref else float(aux[k].detach())
           for k, ref in want_aux.items()}
    assert max(rel.values()) <= 1e-5, rel
    assert want_aux["temp"] > 0 and want_aux["feature1"] > 0
    model_state = model.state_dict()
    for name, ref in convert_flax_variables({"batch_stats": want_stats}).items():
        np.testing.assert_allclose(model_state[name].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)

    grads = convert_flax_variables({"params": grads})
    updates = convert_flax_variables({"params": updates})
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.zero_()   # so the step leaves exactly the update in p
            p.grad = grads[name].clone()
    state.opt.step(learning_rate(state.step, cfg))
    assert state.opt.count == 2
    for name, p in model.named_parameters():
        ref = updates[name]
        err = float((p.detach() - ref).abs().max())
        assert err <= 1e-7 * float(ref.abs().max()), (name, err)


def _write_clip(root):
    os.makedirs(root / "unstable")
    w = video_io.VideoWriter(str(root / "unstable" / "clip.avi"), 30.0, (96, 128))
    for f in make_video(12, 96, 128, seed=3, jitter=4.0):
        w.write(f)
    w.close()
    (root / "list.txt").write_text("clip.avi\n")


def _served(monkeypatch, driver_cls):
    """Record each ClipResult that `driver_cls.stabilize_file` returns."""
    results = []
    original = driver_cls.stabilize_file

    def spy(self, *a, **kw):
        res = original(self, *a, **kw)
        results.append(res)
        return res

    monkeypatch.setattr(driver_cls, "stabilize_file", spy)
    return results


def test_cli_serves_the_converted_directory_as_jax_serves_the_original(
        dirs, tmp_path, monkeypatch):
    if video_io.optional_cv2() is None:
        pytest.skip("needs OpenCV file I/O")
    jax_dir, port_dir = dirs
    # TINY in f32 under its own name, in both registries, for the CLIs.
    for module in (jax_config_mod, config_mod):
        monkeypatch.setitem(module._REGISTRY, F32, module.get_config("tiny").replace(
            name=F32, compute_dtype="float32"))
    _write_clip(tmp_path)
    common = ["--config", F32, "--test-list", str(tmp_path / "list.txt"),
              "--prefix", str(tmp_path)]
    got, want = _served(monkeypatch, StreamDriver), _served(monkeypatch, JaxStreamDriver)
    port_cli(["stabilize", *common, "--model-dir", port_dir,
              "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_cli(["stabilize", *common, "--model-dir", jax_dir,
             "--output-dir", str(tmp_path / "jax")])
    assert len(got) == len(want) == 1
    got, want = got[0], want[0]
    assert got.crop_rect == want.crop_rect
    for a, b in ((got.frames, want.frames), (got.cropped, want.cropped)):
        assert a.shape == b.shape
        diff = np.abs(a.astype(np.int32) - np.asarray(b).astype(np.int32))
        assert diff.max() <= 1, diff.max()


def test_unconverted_directory_names_the_converter(dirs, tmp_path):
    jax_dir, _ = dirs
    with pytest.raises(FileNotFoundError, match="torch_from_orbax.py"):
        ckpt.load_model_state(jax_dir)
    _, state = _restored()
    with pytest.raises(FileNotFoundError, match=r"Orbax checkpoint .*\(step 1\)"):
        ckpt.restore(jax_dir, state)
    with pytest.raises(FileNotFoundError, match="torch_from_orbax.py"):
        port_cli(["stabilize", "--config", "tiny", "--model-dir", jax_dir,
                  "--test-list", str(tmp_path / "none.txt"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="^no checkpoint in"):
        ckpt.load_model_state(str(tmp_path))
