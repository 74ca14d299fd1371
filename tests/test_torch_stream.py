"""The port's streaming engine, driver and CLI against the JAX package.

TINY in f32 with the JAX package's initial weights (theta head scaled by
0.05), converted to the port.  The reference is the JAX engine's XLA path
(`use_pallas=False`); the port runs its kernels' plain versions on the CPU.
S=2 streams of T=12 frames, so the 4-slot history ring wraps.
Tolerances: stabilized frames within 1 uint8 LSB (the two frameworks round
convolutions and solves differently in the last bits); the accumulated black
map and the crop rectangle equal.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.models import init_variables, make_model as jax_make_model
from stabnet_tpu.models import scale_theta_head as jax_scale_theta_head
from stabnet_tpu.stream import DeployOptions as JaxDeployOptions
from stabnet_tpu.stream import StreamDriver as JaxStreamDriver
from stabnet_tpu.stream import StreamEngine as JaxStreamEngine
from stabnet_tpu.stream.engine import crop_rectangle as jax_crop_rectangle
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.models import convert_flax_variables, make_model
from stabnet_tpu_torch.stream import (DeployOptions, StreamDriver, StreamEngine,
                                      crop_rectangle, video_io)

torch.set_num_threads(1)

S, T, HF, WF = 2, 12, 96, 128


@functools.lru_cache(maxsize=None)
def _jax_model():
    cfg = jax_config("tiny").replace(compute_dtype="float32")
    model = jax_make_model(cfg)
    variables = jax_scale_theta_head(
        init_variables(model, cfg, jax.random.PRNGKey(0)), 0.05)
    return cfg, model, variables


def _port_model():
    cfg = get_config("tiny").replace(compute_dtype="float32")
    model = make_model(cfg)
    model.load_state_dict(convert_flax_variables(_jax_model()[2]))
    return cfg, model


@functools.lru_cache(maxsize=None)
def _clips():
    colors = np.stack([make_video(T, HF, WF, seed=s, jitter=4.0) for s in range(S)])
    cfg = get_config("tiny")
    grays = np.stack([[video_io.to_gray_train(f, cfg.height, cfg.width,
                                              cfg.crop_rate if t == 0 else 1.0)
                       for t, f in enumerate(c)] for c in colors])
    return grays, colors


def _assert_lsb(got, want):
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("refine", [1, 2])
def test_engine_matches_jax_and_steps_match_clip(refine):
    grays, colors = _clips()
    jcfg, jmodel, variables = _jax_model()
    jw, jstate = JaxStreamEngine(jmodel, variables, jcfg, refine=refine,
                                 use_pallas=False).stabilize_clip(grays, colors)
    cfg, model = _port_model()
    engine = StreamEngine(model, cfg, refine=refine, device="cpu")
    tw, tstate = engine.stabilize_clip(grays, colors)
    assert tw.shape == (S, T - 1, HF, WF, 3) and tw.dtype == torch.uint8
    _assert_lsb(tw.numpy(), jw)
    jblack, tblack = np.asarray(jstate.all_black), tstate.all_black.numpy()
    np.testing.assert_array_equal(tblack, jblack)
    assert 0 < (tblack > 0).mean() < 0.5
    for s in range(S):
        assert crop_rectangle(tblack[s]) == jax_crop_rectangle(jblack[s])

    # The per-frame step is the clip loop's own step.
    state = engine.init(grays[:, 0])
    for t in range(1, T):
        state, out = engine.step(state, grays[:, t], colors[:, t])
        _assert_lsb(out.warped_color.numpy(), tw[:, t - 1].numpy())
    np.testing.assert_array_equal(state.all_black.numpy(), tblack)


def test_unequal_lengths_freeze_like_jax():
    """A per-stream prefix `valid` mask freezes a stream's ring and crop
    accumulator at its true end, as the JAX scan does."""
    grays, colors = _clips()
    valid = np.ones((S, T - 1), bool)
    valid[1, 6:] = False
    jcfg, jmodel, variables = _jax_model()
    jw, jstate = JaxStreamEngine(jmodel, variables, jcfg, use_pallas=False
                                 ).stabilize_clip(grays, colors, valid=valid)
    cfg, model = _port_model()
    tw, tstate = StreamEngine(model, cfg, device="cpu").stabilize_clip(
        grays, colors, valid=valid)
    _assert_lsb(tw.numpy()[0], np.asarray(jw)[0])
    _assert_lsb(tw.numpy()[1, :6], np.asarray(jw)[1, :6])
    np.testing.assert_array_equal(tstate.all_black.numpy(),
                                  np.asarray(jstate.all_black))


@pytest.mark.parametrize("device_gray,output_size", [(False, None),
                                                     (True, (72, 96))])
def test_driver_matches_jax(device_gray, output_size):
    _, colors = _clips()
    jcfg, jmodel, variables = _jax_model()
    jres = JaxStreamDriver(
        JaxStreamEngine(jmodel, variables, jcfg, out_hw=output_size,
                        use_pallas=False),
        JaxDeployOptions(device_gray=device_gray, output_size=output_size)
    ).stabilize_clip(colors[0])
    cfg, model = _port_model()
    res = StreamDriver(StreamEngine(model, cfg, out_hw=output_size, device="cpu"),
                       DeployOptions(device_gray=device_gray,
                                     output_size=output_size)).stabilize_clip(colors[0])
    assert res.frames.shape == (T,) + (output_size or (HF, WF)) + (3,)
    _assert_lsb(res.frames, jres.frames)
    assert res.crop_rect == tuple(jres.crop_rect)
    assert res.cropped.shape == jres.cropped.shape
    np.testing.assert_array_equal(res.all_black, np.asarray(jres.all_black))


@pytest.mark.parametrize("device_gray", [False, True])
def test_driver_collects_the_steps_input_grays(device_gray):
    """`collect_input_gray` keeps each frame's model-scale input, as the
    step computed it (host or device), frame 0 without the crop zoom."""
    from stabnet_tpu_torch.stream.engine import gray_from_color

    _, colors = _clips()
    cfg, model = _port_model()
    engine = StreamEngine(model, cfg, device="cpu")
    res = StreamDriver(engine, DeployOptions(device_gray=device_gray,
                                             collect_input_gray=True)
                       ).stabilize_clip(colors[0])
    assert res.input_gray.shape == (T, cfg.height, cfg.width)
    assert res.input_gray.dtype == np.float32
    if device_gray:
        want = gray_from_color(torch.from_numpy(colors[0]).permute(0, 3, 1, 2),
                               (cfg.height, cfg.width)).numpy()
    else:
        want = np.stack([video_io.to_gray_train(f, cfg.height, cfg.width) for f in colors[0]])
    np.testing.assert_array_equal(res.input_gray, want)
    plain = StreamDriver(engine, DeployOptions(device_gray=device_gray)).stabilize_clip(colors[0])
    assert plain.input_gray is None
    np.testing.assert_array_equal(plain.frames, res.frames)


def _write_clip(tmp_path, frames):
    cv2 = pytest.importorskip("cv2")
    (tmp_path / "unstable").mkdir()
    writer = cv2.VideoWriter(str(tmp_path / "unstable" / "demo.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 30, (WF, HF))
    for f in frames:
        writer.write(f)
    writer.release()
    (tmp_path / "list.txt").write_text("demo.avi\n")


def test_cli_stabilize_metrics(tmp_path, capsys):
    """`stabilize --metrics`: one JSON line of scores per clip."""
    import json

    from stabnet_tpu_torch.cli.main import main

    _, colors = _clips()
    _write_clip(tmp_path, colors[0])
    main(["stabilize", "--config", "tiny", "--test-list", str(tmp_path / "list.txt"),
          "--prefix", str(tmp_path), "--output-dir", str(tmp_path / "out"),
          "--metrics", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    records = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(records) == 1 and "demo.avi: 12 frames" in lines[0]
    scores = records[0]
    assert set(scores) == {"stability", "cropping", "distortion", "stability_input",
                           "crop_area", "video"}
    assert scores["video"] == "demo.avi"
    for k, v in scores.items():
        if k != "video":
            assert 0.0 < v <= 1.0 + 1e-6, (k, v)


def test_cli_stabilize_with_weights(tmp_path, capsys):
    """`stabilize --weights <npz>` on a video file: the .npz holds the Flax
    variables keyed by "/"-joined paths; both output videos hold every frame."""
    cv2 = pytest.importorskip("cv2")
    from flax.traverse_util import flatten_dict

    from stabnet_tpu_torch.cli.main import main

    _, colors = _clips()
    _write_clip(tmp_path, colors[0])
    variables = jax.tree_util.tree_map(np.asarray, _jax_model()[2])
    np.savez(tmp_path / "w.npz", **flatten_dict(variables, sep="/"))

    main(["stabilize", "--config", "tiny", "--test-list", str(tmp_path / "list.txt"),
          "--prefix", str(tmp_path), "--output-dir", str(tmp_path / "out"),
          "--weights", str(tmp_path / "w.npz"), "--device", "cpu"])
    assert "demo.avi: 12 frames" in capsys.readouterr().out
    for name, hw in (("demo.avi.avi", (HF, WF)), ("demo.avi_cut.avi", None)):
        cap = cv2.VideoCapture(os.path.join(tmp_path, "out", "output", name))
        frames = []
        ok, f = cap.read()
        while ok:
            frames.append(f)
            ok, f = cap.read()
        cap.release()
        assert len(frames) == T
        if hw:
            assert frames[0].shape[:2] == hw
