"""The port's serving modes against the JAX package and against each other.

TINY in f32 with the JAX package's initial weights (theta head scaled by
0.05), converted to the port; one JAX engine (the XLA path,
`use_pallas=False`) and one port engine on the CPU serve the whole module.
Bounds: against JAX, stabilized frames and vis mosaics within 1 uint8 LSB
(the two frameworks round convolutions and solves differently in the last
bits), the accumulated black map and the crop equal (the stream bound of
tests/test_torch_stream.py).  Within the port, the pipelined, chunked,
padded and streamed modes run the same operations as the synchronous,
unchunked, alone and batched ones, so they must agree bit for bit.
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
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.models import convert_flax_variables, make_model
from stabnet_tpu_torch.stream import (DeployOptions, StreamDriver, StreamEngine,
                                      video_io)
from stabnet_tpu_torch.stream.driver import _bounce

torch.set_num_threads(1)

T, HF, WF = 12, 96, 128


@functools.lru_cache(maxsize=None)
def _engines():
    """(JAX engine, port engine) on the same weights."""
    jcfg = jax_config("tiny").replace(compute_dtype="float32")
    jmodel = jax_make_model(jcfg)
    variables = jax_scale_theta_head(
        init_variables(jmodel, jcfg, jax.random.PRNGKey(0)), 0.05)
    cfg = get_config("tiny").replace(compute_dtype="float32")
    model = make_model(cfg)
    model.load_state_dict(convert_flax_variables(variables))
    return (JaxStreamEngine(jmodel, variables, jcfg, use_pallas=False),
            StreamEngine(model, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _clips():
    """Two shaky clips and the first one's stable ground truth."""
    shaky = [make_video(T, HF, WF, seed=s, jitter=4.0) for s in range(2)]
    return shaky, make_video(T, HF, WF, seed=0, jitter=0.0)


def _driver(**kw):
    return StreamDriver(_engines()[1], DeployOptions(**kw))


def _jax_driver(**kw):
    return JaxStreamDriver(_engines()[0], JaxDeployOptions(**kw))


def _assert_lsb(got, want):
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, diff.max()


def _assert_same(a, b):
    """Two ClipResults of the port agree bit for bit."""
    np.testing.assert_array_equal(a.frames, b.frames)
    np.testing.assert_array_equal(a.all_black, b.all_black)
    assert a.crop_rect == b.crop_rect


def _batch(chunk=None, pad_streams=None, which=(0, 1)):
    """The port's batch of clip 0 (12 frames) and clip 1 cut to 7."""
    shaky, _ = _clips()
    clips = [shaky[0], shaky[1][:7]]
    return _driver().stabilize_batch([clips[i] for i in which], chunk=chunk,
                                     pad_streams=pad_streams)


@pytest.mark.parametrize("device_gray", [False, True])
def test_pipelined_matches_sync(device_gray):
    """The one-frame readback lag changes no output byte; every frame has
    its dispatch, readback and "net" (the two together) recorded."""
    clip = _clips()[0][0]
    sync = _driver(pipelined=False, device_gray=device_gray).stabilize_clip(clip)
    piped = _driver(device_gray=device_gray).stabilize_clip(clip)
    _assert_same(piped, sync)
    np.testing.assert_array_equal(piped.cropped, sync.cropped)
    for res in (sync, piped):
        for stage in ("dispatch", "readback", "net"):
            assert res.stage_summary[stage]["count"] == T - 1


def test_batch_matches_jax():
    """Two clips of unequal length as lock-step streams, against JAX."""
    shaky, _ = _clips()
    clips = [shaky[0], shaky[1][:7]]
    got = _batch()
    want = _jax_driver().stabilize_batch(clips)
    for g, w, clip in zip(got, want, clips):
        assert g.frames.shape == (len(clip), HF, WF, 3)
        _assert_lsb(g.frames, w.frames)
        np.testing.assert_array_equal(g.all_black, np.asarray(w.all_black))
        assert g.crop_rect == tuple(w.crop_rect)
        assert g.cropped.shape == w.cropped.shape
    assert set(got[0].stage_summary) == {"pre", "scan"}


def test_chunked_batch_matches_unchunked():
    """Chunks of 4 pad the 11 scanned steps to 12; the eager scan runs the
    same operations either way."""
    for a, b in zip(_batch(chunk=4), _batch()):
        _assert_same(a, b)


def test_padded_batch_clip_matches_the_clip_alone():
    """Each clip of a batch padded to 3 streams against the same clip alone
    at 3 streams: the valid mask freezes a clip exactly at its end."""
    both = _batch(pad_streams=3)
    for i in (0, 1):
        _assert_same(both[i], _batch(pad_streams=3, which=(i,))[0])


def test_streaming_over_arrays_matches_chunked_batch():
    """`stabilize_stream` from an array reader to an array writer, 5 frames
    at a time (a padded tail), against the chunked batch of the clip."""
    clip = _clips()[0][0]
    writer = video_io.ArrayVideoWriter()
    res = _driver().stabilize_stream(video_io.ArrayVideoReader(clip), writer, 5)
    assert res.frames is None and res.num_frames == T
    want = _driver().stabilize_batch([clip], chunk=5)[0]
    np.testing.assert_array_equal(writer.stack(), want.frames)
    np.testing.assert_array_equal(res.all_black, want.all_black)
    assert res.crop_rect == want.crop_rect


def test_streaming_file_matches_chunked_batch(tmp_path):
    """`stabilize_file(stream_chunk=5)` writes the chunked batch's frames
    (as encoded) and a cut of the crop's size."""
    pytest.importorskip("cv2")
    clip = _clips()[0][0]
    src = str(tmp_path / "clip.avi")
    StreamDriver._write_video(src, clip, 30.0)
    decoded = np.stack(list(video_io.VideoReader(src)))
    driver = _driver()
    res = driver.stabilize_file(src, str(tmp_path / "streamed"), stream_chunk=5)
    assert res.frames is None and res.num_frames == T
    want = driver.stabilize_batch([decoded], chunk=5)[0]
    assert res.crop_rect == want.crop_rect
    StreamDriver._write_video(str(tmp_path / "ref.avi"), want.frames, 30.0)

    def read(path):
        return np.stack(list(video_io.VideoReader(path, allow_half_rate=False)))

    out = tmp_path / "streamed" / "output"
    np.testing.assert_array_equal(read(str(out / "clip.avi.avi")),
                                  read(str(tmp_path / "ref.avi")))
    ys, xs = driver._crop_slices(res.crop_rect, (HF, WF))
    assert read(str(out / "clip.avi_cut.avi")).shape == (
        T, ys.stop - ys.start, xs.stop - xs.start, 3)


ABLATIONS = [
    dict(infer_with_last=True),
    dict(infer_with_stable=True, random_black=5),
    dict(max_span=3),
    dict(start_with_stable=True),
    dict(deploy_vis=True),
]


@pytest.mark.parametrize("opts", ABLATIONS, ids=lambda o: "+".join(o))
def test_ablation_modes_match_jax(opts):
    """The reference's ablation flags and the vis mosaics with a stable
    ground-truth clip, against the JAX driver."""
    shaky, stable = _clips()
    got = _driver(**opts).stabilize_clip(shaky[0], stable)
    want = _jax_driver(**opts).stabilize_clip(shaky[0], stable)
    assert got.frames.shape == (T, HF, WF, 3)
    _assert_lsb(got.frames, want.frames)
    np.testing.assert_array_equal(got.all_black, np.asarray(want.all_black))
    assert got.crop_rect == tuple(want.crop_rect)
    if opts.get("deploy_vis"):
        cfg = get_config("tiny")
        assert got.vis.shape == (T - 1, 2 * cfg.height, 2 * cfg.width, 3)
        _assert_lsb(got.vis, want.vis)
    else:
        assert got.vis is None and want.vis is None


def test_bounce_matches_jax():
    """The occlusion offset bounces inside [0, bound), as JAX's does."""
    from stabnet_tpu.stream.driver import _bounce as jax_bounce

    got, want = [(0, 5)], [(0, 5)]
    for _ in range(40):
        got.append(_bounce(*got[-1][:1], 50, got[-1][1]))
        want.append(jax_bounce(*want[-1][:1], 50, want[-1][1]))
    assert got == want
    assert max(d for d, _ in got) == 45 and min(d for d, _ in got[1:]) == 0


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_rejections_match_jax(tmp_path):
    """Every refusal of a serving mode, with the JAX package's message."""
    shaky, stable = _clips()
    clip = shaky[0]
    cases = [
        (dict(pipelined=True, deploy_vis=True), lambda d: d.stabilize_clip(clip, stable)),
        (dict(max_span=3), lambda d: d.stabilize_batch([clip])),
        (dict(start_with_stable=True), lambda d: d.stabilize_batch([clip])),
        ({}, lambda d: d.stabilize_batch([])),
        ({}, lambda d: d.stabilize_batch([clip, clip[:1]])),
        ({}, lambda d: d.stabilize_batch([clip, clip[:, :48]])),
        (dict(deploy_vis=True),
         lambda d: d.stabilize_file("missing.avi", str(tmp_path), stream_chunk=4)),
        (dict(collect_input_gray=True),
         lambda d: d.stabilize_file("missing.avi", str(tmp_path), stream_chunk=4)),
        ({}, lambda d: d.stabilize_file("missing.avi", str(tmp_path), stream_chunk=0)),
        ({}, lambda d: d.stabilize_batch([clip], sharded=True, chunk=4)),
    ]
    for opts, call in cases:
        assert _error(lambda: call(_driver(**opts))) == \
            _error(lambda: call(_jax_driver(**opts))), opts
    assert not os.listdir(tmp_path)   # refused before any output file


def test_reconcile_chunk():
    """A live engine passes a requested chunk through; an engine with a
    baked scan segment imposes it and refuses another, as in JAX."""

    class Baked:
        cfg = get_config("tiny")
        segment = 64

    live = _driver()
    assert live.reconcile_chunk(None) is None and live.reconcile_chunk(16) == 16
    baked = StreamDriver(Baked())
    assert baked.reconcile_chunk(None) == 64 and baked.reconcile_chunk(64) == 64
    msg = _error(lambda: baked.reconcile_chunk(16))
    assert msg == _error(lambda: JaxStreamDriver(Baked()).reconcile_chunk(16))
    assert "baked 64-frame" in msg


def test_cli_list_files_and_conflicts(tmp_path):
    """`--test-list` skips missing list files and defaults to both of the
    JAX package's lists; `--stream-chunk` refuses `--batch` and `--metrics`."""
    from stabnet_tpu_torch.cli.main import _read_video_lists, main

    (tmp_path / "list.txt").write_text("a.avi\n\nb.avi\n")
    assert _read_video_lists([str(tmp_path / "missing"), str(tmp_path / "list.txt")]) \
        == ["a.avi", "b.avi"]
    assert _read_video_lists([str(tmp_path / "missing")]) == []
    base = ["stabilize", "--config", "tiny", "--device", "cpu", "--stream-chunk", "4"]
    for extra in (["--batch", "2"], ["--metrics"]):
        with pytest.raises(SystemExit, match="--stream-chunk"):
            main(base + extra)
    import argparse

    from stabnet_tpu_torch.cli import main as cli_main

    seen = {}
    real = cli_main.cmd_stabilize
    cli_main.cmd_stabilize = lambda args: seen.setdefault("args", args)
    try:
        main(["stabilize"])
    finally:
        cli_main.cmd_stabilize = real
    assert isinstance(seen["args"], argparse.Namespace)
    assert seen["args"].test_list == ["data_video/test_list",
                                      "data_video/train_list_deploy"]


def test_cli_batch_and_vis(tmp_path, capsys):
    """`stabilize --batch 2` writes each clip's videos; `--deploy-vis` reads
    `<prefix>/stable/<name>` and writes `output-vis/<name>.avi`."""
    cv2 = pytest.importorskip("cv2")
    from stabnet_tpu_torch.cli.main import main

    shaky, stable = _clips()
    for d in ("unstable", "stable"):
        (tmp_path / d).mkdir()
    for i, clip in enumerate(shaky):
        StreamDriver._write_video(str(tmp_path / "unstable" / f"c{i}.avi"), clip, 30.0)
    StreamDriver._write_video(str(tmp_path / "stable" / "c0.avi"), stable, 30.0)
    (tmp_path / "list.txt").write_text("c0.avi\nc1.avi\n")
    base = ["stabilize", "--config", "tiny", "--test-list", str(tmp_path / "list.txt"),
            "--prefix", str(tmp_path), "--device", "cpu"]
    main(base + ["--output-dir", str(tmp_path / "b"), "--batch", "2"])
    main(base + ["--output-dir", str(tmp_path / "v"), "--deploy-vis"])
    out = capsys.readouterr().out
    assert out.count("batch fps=") == 2 and out.count(": 12 frames") == 4

    def frames(path):
        cap = cv2.VideoCapture(str(path))
        got = []
        ok, f = cap.read()
        while ok:
            got.append(f)
            ok, f = cap.read()
        cap.release()
        return got

    for i in (0, 1):
        assert len(frames(tmp_path / "b" / "output" / f"c{i}.avi.avi")) == T
    cfg = get_config("tiny")
    vis = frames(tmp_path / "v" / "output-vis" / "c0.avi.avi")
    assert len(vis) == T - 1 and vis[0].shape == (2 * cfg.height, 2 * cfg.width, 3)
    assert len(frames(tmp_path / "v" / "output-vis" / "c1.avi.avi")) == T - 1
