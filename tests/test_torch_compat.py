"""The port's TF-slim checkpoint import and ImageNet transfer against the JAX
package's, and the CLI paths that carry weights in (needs TensorFlow).

The checkpoints are synthetic: the exact slim variable inventory of
resnet_v2_50 (+ the StabNet head) with seeded values, written by TensorFlow
with the helpers of tests/test_tf_parity.py.  The conversion copies and
transposes, so the port's state_dict must equal the JAX conversion's,
converted by `convert_flax_variables`, key for key and bit for bit.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("tensorflow")

import jax

from stabnet_tpu.compat import convert_resnet_v2_50 as jax_convert_resnet_v2_50
from stabnet_tpu.compat import convert_stabnet_checkpoint as jax_convert_stabnet_checkpoint
from stabnet_tpu.compat import tensor_name_map as jax_tensor_name_map
from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.models import init_variables, make_model as jax_make_model
from stabnet_tpu.train.checkpoint import transfer_from_imagenet as jax_transfer
from stabnet_tpu_torch.compat import (convert_imagenet_checkpoint, convert_resnet_v2_50,
                                      convert_stabnet_checkpoint, load_tf_checkpoint,
                                      tensor_name_map)
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.models import convert_flax_variables, make_model
from stabnet_tpu_torch.train import checkpoint as ckpt
from tests.test_tf_parity import random_values, slim_var_shapes, write_tf_checkpoint

torch.set_num_threads(1)

TRUNK, HEAD = "stable_net/resnet/resnet_v2_50", "stable_net/resnet/fc"


def _stabnet_values(in_ch, seed):
    values = random_values(slim_var_shapes(in_ch, prefix=TRUNK, head_prefix=HEAD), seed)
    # The theta layer at production magnitude, as scale_theta_head does, so
    # the served warps keep a black-free crop.
    for k in (f"{HEAD}/fc_weights", f"{HEAD}/fc_bias"):
        values[k] = values[k] * np.float32(0.05)
    return values


@functools.lru_cache(maxsize=None)
def _imagenet_values():
    return random_values(slim_var_shapes(3), seed=5)


@functools.lru_cache(maxsize=None)
def _jax_tiny_variables():
    jcfg = jax_config("tiny")
    return init_variables(jax_make_model(jcfg), jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """checkpoint(kind): the path of a slim checkpoint written once per
    module: "v2_93" (13 channels), "tiny" (TINY's 7) or "imagenet" (a
    3-channel trunk)."""
    paths = {}

    def get(kind: str) -> str:
        if kind not in paths:
            values = (_imagenet_values() if kind == "imagenet"
                      else _stabnet_values(get_config(kind).in_channels, seed=1))
            paths[kind] = write_tf_checkpoint(str(tmp_path_factory.mktemp(kind)), values)
        return paths[kind]

    return get


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def test_stabnet_checkpoint_matches_jax_conversion(checkpoint):
    """A trained-model checkpoint: equal to the JAX conversion, and loads
    strictly into the full-width v2_93 regressor."""
    path = checkpoint("v2_93")
    got = convert_stabnet_checkpoint(path)
    want = convert_flax_variables(
        jax.tree_util.tree_map(np.asarray, jax_convert_stabnet_checkpoint(path)))
    _assert_state_equal(got, want)
    make_model(get_config("v2_93")).load_state_dict(got, strict=True)


def test_theta_of_converted_v2_93_matches_jax(checkpoint):
    """The converted weights in both frameworks give the same theta (f32)."""
    path = checkpoint("v2_93")
    jcfg = jax_config("v2_93").replace(compute_dtype="float32")
    cfg = get_config("v2_93").replace(compute_dtype="float32")
    variables = jax_convert_stabnet_checkpoint(path)
    model = make_model(cfg)
    model.load_state_dict(convert_stabnet_checkpoint(path))
    x = np.random.RandomState(2).rand(1, 64, 96, 13).astype(np.float32) - 0.5
    want = np.asarray(jax_make_model(jcfg).apply(variables, x, train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_imagenet_transfer_matches_jax(checkpoint):
    """The 3-channel trunk's mapping and graft against JAX's: every unit
    but conv1 replaced, BN statistics included, the stem and head kept."""
    values = _imagenet_values()
    trunk = convert_resnet_v2_50(values)
    _assert_state_equal(convert_imagenet_checkpoint(checkpoint("imagenet")), trunk)
    variables = _jax_tiny_variables()
    model_state = convert_flax_variables(variables)
    got = ckpt.transfer_from_imagenet(model_state, trunk)
    jp, js = jax_convert_resnet_v2_50(values)
    want = convert_flax_variables(jax.tree_util.tree_map(
        np.asarray, jax_transfer(variables, jp, js)))
    _assert_state_equal(got, want)
    for k in ("resnet_v2_50.conv1.conv.weight", "head.out.weight"):
        assert torch.equal(got[k], model_state[k])
    assert torch.equal(got["resnet_v2_50.postnorm.running_var"],
                       torch.from_numpy(values["resnet_v2_50/postnorm/moving_variance"]))


def _refusal_inputs(case, values):
    """(JAX trunk params and stats, port trunk state) broken one way."""
    jp, js = (jax.tree_util.tree_map(np.asarray, t) for t in jax_convert_resnet_v2_50(values))
    trunk = convert_resnet_v2_50(values)
    unit = "resnet_v2_50.block4_unit3."
    if case == "missing":
        del jp["block4_unit3"], js["block4_unit3"]
        trunk = {k: v for k, v in trunk.items() if not k.startswith(unit)}
    elif case == "extra":
        jp["block5_unit1"], js["block5_unit1"] = jp["block4_unit3"], js["block4_unit3"]
        trunk.update({k.replace("block4_unit3", "block5_unit1"): v
                      for k, v in trunk.items() if k.startswith(unit)})
    else:
        jp["block1_unit1"]["conv3"]["bias"] = np.zeros(7, np.float32)
        trunk["resnet_v2_50.block1_unit1.conv3.bias"] = torch.zeros(7)
    return jp, js, trunk


@pytest.mark.parametrize("case,error,words", [
    ("missing", KeyError, "lacks params for model trunk unit(s) ['block4_unit3']"),
    ("extra", KeyError, "pretrained trunk has params/'block5_unit1' but the model"),
    ("misshapen", ValueError, "shape mismatch grafting params/block1_unit1"),
])
def test_transfer_refusals_match_jax(case, error, words):
    jp, js, trunk = _refusal_inputs(case, _imagenet_values())
    variables = _jax_tiny_variables()
    with pytest.raises(error) as jax_err:
        jax_transfer(variables, jp, js)
    with pytest.raises(error) as port_err:
        ckpt.transfer_from_imagenet(convert_flax_variables(variables), trunk)
    assert words in str(port_err.value) and words in str(jax_err.value)


def test_load_tf_checkpoint_needs_tensorflow(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(RuntimeError, match="TensorFlow is required"):
        load_tf_checkpoint("model-80000")


def test_tensor_name_map_matches_jax():
    assert tensor_name_map() == jax_tensor_name_map()


def _video(tmp_path, name="demo.avi", seed=0):
    from stabnet_tpu_torch.data.synthetic import make_video
    from stabnet_tpu_torch.stream import StreamDriver

    (tmp_path / "unstable").mkdir(exist_ok=True)
    StreamDriver._write_video(str(tmp_path / "unstable" / name),
                              make_video(6, 96, 128, seed=seed, jitter=3.0), 30.0)
    (tmp_path / "list.txt").write_text(name + "\n")


def _decode(path):
    from stabnet_tpu_torch.stream.video_io import VideoReader

    return np.stack(list(VideoReader(str(path), allow_half_rate=False)))


def _stabilize(tmp_path, out, *flags):
    from stabnet_tpu_torch.cli.main import main

    main(["stabilize", "--config", "tiny", "--test-list", str(tmp_path / "list.txt"),
          "--prefix", str(tmp_path), "--output-dir", str(tmp_path / out),
          "--device", "cpu", *flags])
    return _decode(tmp_path / out / "output" / "demo.avi.avi")


def test_cli_convert_ckpt_serves_like_tf_checkpoint(tmp_path, checkpoint):
    """`convert-ckpt` then `stabilize --model-dir` gives the frames of
    `stabilize --tf-checkpoint`; `train --restore` reads the same file."""
    pytest.importorskip("cv2")
    from stabnet_tpu_torch.cli.main import main
    from stabnet_tpu_torch.train.state import create_train_state

    path = checkpoint("tiny")
    main(["convert-ckpt", "--tf-checkpoint", path, "--out", str(tmp_path / "ck"),
          "--config", "tiny"])
    assert ckpt.latest_step(str(tmp_path / "ck")) == 0
    _video(tmp_path)
    via_dir = _stabilize(tmp_path, "a", "--model-dir", str(tmp_path / "ck"))
    via_tf = _stabilize(tmp_path, "b", "--tf-checkpoint", path)
    assert via_dir.shape == (6, 96, 128, 3)
    np.testing.assert_array_equal(via_dir, via_tf)
    state = ckpt.restore(str(tmp_path / "ck"),
                         create_train_state(get_config("tiny"), device="cpu"))
    assert state.step == 0
    _assert_state_equal(state.model.state_dict(), convert_stabnet_checkpoint(path))


def _synthetic(tmp_path):
    from stabnet_tpu_torch.cli.main import main

    main(["make-synthetic", "--out", str(tmp_path / "data" / "train"), "--num", "4",
          "--config", "tiny"])


def test_cli_train_then_serve_model_dir(tmp_path):
    """`train --steps 1` then `stabilize --model-dir` serves the trained
    weights: its frames equal an engine loaded from the state.pt by hand."""
    pytest.importorskip("cv2")
    from stabnet_tpu_torch.cli.main import main
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine

    _synthetic(tmp_path)
    main(["train", "--config", "tiny", "--data", str(tmp_path / "data"),
          "--model-dir", str(tmp_path / "m"), "--log-dir", str(tmp_path / "log"),
          "--steps", "1", "--device", "cpu"])
    _video(tmp_path)
    served = _stabilize(tmp_path, "out", "--model-dir", str(tmp_path / "m"))
    cfg = get_config("tiny")
    model = make_model(cfg)
    model.load_state_dict(torch.load(os.path.join(tmp_path, "m", "1", "state.pt"),
                                     weights_only=True)["model"])
    driver = StreamDriver(StreamEngine(model, cfg, device="cpu"), DeployOptions())
    driver.stabilize_file(str(tmp_path / "unstable" / "demo.avi"), str(tmp_path / "hand"))
    np.testing.assert_array_equal(served, _decode(tmp_path / "hand" / "output" / "demo.avi.avi"))


def test_cli_train_imagenet_ckpt(tmp_path, caplog, checkpoint):
    """`train --imagenet-ckpt` grafts the trunk before the first step: after
    one Adam step (at most the learning rate per weight) the trunk's weights
    are the pretrained ones; conv1 keeps TINY's stem."""
    from stabnet_tpu_torch.cli.main import main
    from stabnet_tpu_torch.utils import get_logger

    _synthetic(tmp_path)
    path = checkpoint("imagenet")
    # The port's logger does not propagate to the root logger, where caplog
    # listens: hand caplog's handler to it for the call.
    get_logger().addHandler(caplog.handler)
    try:
        main(["train", "--config", "tiny", "--data", str(tmp_path / "data"),
              "--model-dir", str(tmp_path / "m"), "--log-dir", str(tmp_path / "log"),
              "--steps", "1", "--device", "cpu", "--imagenet-ckpt", path])
    finally:
        get_logger().removeHandler(caplog.handler)
    assert f"transferred ImageNet trunk from {path}" in caplog.text
    got = torch.load(os.path.join(tmp_path, "m", "1", "state.pt"), weights_only=True)["model"]
    lr = get_config("tiny").initial_learning_rate
    weights = {k: v for k, v in convert_imagenet_checkpoint(path).items()
               if not k.startswith("resnet_v2_50.conv1.") and "running" not in k}
    assert len(weights) == 170   # every trunk weight but the stem's two
    for k, v in weights.items():
        assert float((got[k] - v).abs().max()) <= 1.01 * lr, k
    assert got["resnet_v2_50.conv1.conv.weight"].shape[1] == get_config("tiny").in_channels
