"""The port's serving artifacts (`torch.export`) against the live engine,
the JAX package's artifacts and the CLI.

TINY on the CPU.  Bounds: the loaded step and the baked segment run the
live step's operations (the ring read by `index_select` and written by an
out-of-place `index_copy`, which are exact), so they equal the live engine
bit for bit at equal stream counts; against the JAX package's
`export_stream_step` artifact on the same inputs, the warped frame within 1
uint8 LSB and the maps and the ring within 1e-4 (the JAX package's own
artifact-against-live bound, tests/test_export.py:54-61: its artifact
solves with a portable solver, and the frameworks round convolutions
differently).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu.models import init_variables, make_model as jax_make_model
from stabnet_tpu.models import scale_theta_head as jax_scale_theta_head
from stabnet_tpu.stream.export import export_stream_step as jax_export_stream_step
from stabnet_tpu.stream.export import initial_state as jax_initial_state
from stabnet_tpu.stream.export import load_stream_step as jax_load_stream_step
from stabnet_tpu.stream.export import save_artifact as jax_save_artifact
from stabnet_tpu_torch.cli.main import main
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.models import convert_flax_variables, make_model, scale_theta_head
from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine, video_io
from stabnet_tpu_torch.stream.export import (_MAGIC, ExportedEngine, _moved,
                                             export_scan_segment, export_stream_step,
                                             initial_state, load_artifact,
                                             load_stream_step, save_artifact,
                                             select_program)

torch.set_num_threads(1)

CFG = get_config("tiny")
OUT_HW = (2 * CFG.height, 2 * CFG.width)


def _engine(refine=1, cfg=CFG, model=None):
    model = model or scale_theta_head(make_model(cfg, torch.Generator().manual_seed(0)), 0.05)
    return StreamEngine(model, cfg, refine=refine, out_hw=OUT_HW, device="cpu")


def _frames(S, T, seed=0):
    rng = np.random.RandomState(seed)
    gray = (rng.rand(S, T, CFG.height, CFG.width) - 0.5).astype(np.float32)
    color = rng.randint(0, 256, (S, T, *OUT_HW, 3), dtype=np.uint8)
    return gray, color


@pytest.fixture(scope="module")
def step_s1():
    engine = _engine()
    return engine, export_stream_step(engine, OUT_HW, streams=1)


@pytest.mark.parametrize("S,refine", [(1, 1), (2, 2)])
def test_loaded_step_is_the_live_step(step_s1, S, refine):
    """Four steps through the loaded artifact against the live engine's
    `stream_step`: every output and the state, bit for bit; the ring
    pointer advances once per step whatever the refine count."""
    engine, data = step_s1 if S == 1 else (None, None)
    if data is None:
        engine = _engine(refine=refine)
        data = export_stream_step(engine, OUT_HW, streams=S)
    step = load_stream_step(data)
    gray, color = _frames(S, 5)
    live = engine.init(gray[:, 0])
    state = initial_state(torch.from_numpy(gray[:, 0]), CFG)
    for t in range(1, 5):
        live, want = engine.step(live, gray[:, t], color[:, t])
        state, got = step(state, torch.from_numpy(gray[:, t]), torch.from_numpy(color[:, t]))
        for name in ("warped_color", "x_map", "y_map", "black", "output_gray"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (t, name)
        assert torch.equal(state.frames, live.frames) and torch.equal(state.masks, live.masks)
        assert torch.equal(state.all_black, live.all_black) and int(state.ptr) == live.ptr


def test_exported_graph_calls_the_kernels(step_s1):
    """The artifact holds K2m and K1 as `torch.ops.stabnet` calls, once per
    step each, not the plain chain (the counterpart of the JAX package's
    Mosaic check, tests/test_export.py:150)."""
    from stabnet_tpu_torch.stream.export import _load_program

    targets = [str(n.target) for n in _load_program(step_s1[1]).graph.nodes
               if n.op == "call_function"]
    assert targets.count("stabnet.warp_mesh.default") == 1
    assert targets.count("stabnet.warp_uint8_cf_lowres.default") == 1
    assert not [t for t in targets if "gather" in t or "grid_sampler" in t]


def test_artifact_matches_the_jax_artifact():
    """One step of the port's artifact against one of the JAX package's,
    exported from the same f32 weights, on the same inputs."""
    jcfg = jax_config("tiny").replace(compute_dtype="float32")
    jmodel = jax_make_model(jcfg)
    variables = jax_scale_theta_head(init_variables(jmodel, jcfg, jax.random.PRNGKey(0)),
                                     0.05)
    jstep = jax_load_stream_step(jax_export_stream_step(jmodel, variables, jcfg, OUT_HW))
    cfg = CFG.replace(compute_dtype="float32")
    model = make_model(cfg)
    model.load_state_dict(convert_flax_variables(variables))
    step = load_stream_step(export_stream_step(_engine(cfg=cfg, model=model), OUT_HW))
    gray, color = _frames(1, 2, seed=3)
    state, got = step(initial_state(torch.from_numpy(gray[:, 0]), cfg),
                      torch.from_numpy(gray[:, 1]), torch.from_numpy(color[:, 1]))
    jstate, want = jstep(jax_initial_state(gray[:, 0], jcfg), gray[:, 1], color[:, 1])
    du8 = np.abs(got.warped_color.numpy().astype(np.int32)
                 - np.asarray(want.warped_color).astype(np.int32))
    assert du8.max() <= 1, du8.max()
    np.testing.assert_allclose(got.x_map.numpy(), np.asarray(want.x_map), atol=1e-4)
    np.testing.assert_allclose(state.frames.numpy(), np.asarray(jstate.frames), atol=1e-4)


@pytest.fixture(scope="module")
def batch_artifact():
    """A 2-stream step and a 4-frame segment of one engine."""
    engine = _engine()
    return (engine, export_stream_step(engine, OUT_HW, streams=2),
            export_scan_segment(engine, OUT_HW, streams=2, segment=4))


def _clips():
    return [np.stack(make_video(n, *OUT_HW, seed=s, jitter=3.0))
            for s, n in ((0, 10), (1, 7))]


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.frames, w.frames)
        np.testing.assert_array_equal(g.all_black, w.all_black)
        assert g.crop_rect == w.crop_rect


def test_segment_serves_unequal_clips_as_the_live_batch(batch_artifact):
    """Clips of 10 and 7 frames: the baked segment (chunk 4 adopted, the
    tail padded) against the live chunked batch, and the step artifact
    against the live unchunked batch, bit for bit at 2 streams."""
    engine, step_data, seg_data = batch_artifact
    live = StreamDriver(engine, DeployOptions())
    seg = StreamDriver(ExportedEngine(step_data, CFG, OUT_HW, streams=2,
                                      scan_data=seg_data, segment=4, device="cpu"))
    stepped = StreamDriver(ExportedEngine(step_data, CFG, OUT_HW, streams=2, device="cpu"))
    clips = _clips()
    _assert_same(seg.stabilize_batch(clips), live.stabilize_batch(clips, chunk=4))
    _assert_same(stepped.stabilize_batch(clips), live.stabilize_batch(clips))
    # The engines' own whole-clip calls: the segment (10 steps, the tail
    # padded) against the step loop, on every valid output and the crop
    # accumulators frozen at each clip's end.
    gray, color = _frames(2, 11, seed=4)
    valid = np.arange(10)[None] < np.array([[10], [6]])
    a, sa = seg.engine.stabilize_clip(gray, color, valid)
    b, sb = stepped.engine.stabilize_clip(gray, color, valid)
    assert torch.equal(a[torch.from_numpy(valid)], b[torch.from_numpy(valid)])
    assert torch.equal(sa.all_black, sb.all_black)


def test_header_round_trip_and_refusals(batch_artifact, tmp_path):
    engine, step_data, seg_data = batch_artifact
    path = str(tmp_path / "a.stbx")
    save_artifact(path, {"cpu": (step_data, seg_data)}, CFG, OUT_HW, 2, 1, segment=4)
    blob, meta = load_artifact(path)
    n = len(step_data)
    assert meta == {"format": "torch.export", "platforms": ["cpu"], "config": "tiny",
                    "out_hw": list(OUT_HW), "streams": 2, "refine": 1,
                    "programs": {"cpu": {"step": [0, n], "segment": [n, len(seg_data)]}},
                    "segment": 4}
    assert blob == step_data + seg_data
    assert select_program(blob, meta, "cpu") == (step_data, seg_data)
    with pytest.raises(ValueError, match="artifact lowered for cpu; current device is cuda"):
        select_program(blob, meta, "cuda")

    jax_path = str(tmp_path / "jax.stbx")
    jax_save_artifact(jax_path, b"payload", jax_config("tiny"), OUT_HW, 1, 1)
    with pytest.raises(ValueError, match="jax.export artifact"):
        load_artifact(jax_path)
    bare = str(tmp_path / "bare.bin")
    with open(bare, "wb") as f:
        f.write(step_data)
    with pytest.raises(ValueError, match="no header"):
        load_artifact(bare)
    other = str(tmp_path / "other.stbx")
    with open(path, "rb") as f:
        raw = f.read()
    with open(other, "wb") as f:
        f.write(raw.replace(b'"torch.export"', b'"onnx-model.."', 1))
    with pytest.raises(ValueError, match="onnx"):
        load_artifact(other)

    eng = ExportedEngine(step_data, CFG, OUT_HW, streams=2, scan_data=seg_data, segment=4,
                         device="cpu")
    gray, color = _frames(2, 6)
    state = eng.init(gray[:, 0])
    with pytest.raises(ValueError, match="production"):
        eng.step(state, gray[:, 1], color[:, 1], history_override=np.zeros(1))
    with pytest.raises(ValueError, match="device-gray"):
        eng.step(state, None, color[:, 1])
    with pytest.raises(ValueError, match="streams"):
        eng.init(gray[:1, 0])
    with pytest.raises(ValueError, match="baked for"):
        eng.continue_clip(state, gray[:, 1:4], color[:, 1:4])
    assert not hasattr(ExportedEngine(step_data, CFG, OUT_HW, streams=2, device="cpu"),
                       "continue_clip")


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    os.makedirs(root / "unstable")
    w = video_io.VideoWriter(str(root / "unstable" / "clip.avi"), 30.0, OUT_HW)
    for f in make_video(9, *OUT_HW, seed=2, jitter=3.0):
        w.write(f)
    w.close()
    (root / "list.txt").write_text("clip.avi\n")
    return root


def _read(path):
    return np.stack(list(video_io.VideoReader(str(path), allow_half_rate=False)))


def test_cli_export_then_stabilize_from_export(videos, tmp_path, capsys):
    """`export` (seeded random weights, as `stabilize` takes them without a
    checkpoint) then `stabilize --from-export` writes the live CLI's video;
    a baked segment serves `--stream-chunk` at its length and refuses
    another before writing anything."""
    if video_io.optional_cv2() is None:
        pytest.skip("needs OpenCV file I/O")
    common = ["--test-list", str(videos / "list.txt"), "--prefix", str(videos),
              "--device", "cpu"]
    art = str(tmp_path / "tiny.stbx")
    main(["export", "--config", "tiny", "--out", art, "--output-size", *map(str, OUT_HW),
          "--device", "cpu", "--selftest"])
    assert "selftest: the loaded artifact ran one step" in capsys.readouterr().out
    main(["stabilize", "--config", "tiny", "--output-dir", str(tmp_path / "live"), *common])
    main(["stabilize", "--from-export", art, "--output-dir", str(tmp_path / "art"), *common])
    for name in ("clip.avi.avi", "clip.avi_cut.avi"):
        np.testing.assert_array_equal(_read(tmp_path / "art" / "output" / name),
                                      _read(tmp_path / "live" / "output" / name))
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["stabilize", "--from-export", art, "--output-dir", str(tmp_path / "x"),
              *common[:-2], "--device", "cuda"])

    seg = str(tmp_path / "seg.stbx")
    main(["export", "--config", "tiny", "--out", seg, "--output-size", *map(str, OUT_HW),
          "--device", "cpu", "--segment", "4"])
    with pytest.raises(SystemExit, match="baked 4-frame"):
        main(["stabilize", "--from-export", seg, "--output-dir", str(tmp_path / "bad"),
              "--stream-chunk", "5", *common])
    assert not os.path.exists(tmp_path / "bad")
    main(["stabilize", "--from-export", seg, "--output-dir", str(tmp_path / "streamed"),
          "--stream-chunk", "4", *common])
    assert _read(tmp_path / "streamed" / "output" / "clip.avi.avi").shape == (9, *OUT_HW, 3)


def test_cli_export_platforms(videos, tmp_path, capsys):
    """`export --platforms cpu` (listed twice) and the default both write a
    header listing the CPU programs; the CPU program serves bit for bit as
    the live engine; `tpu`, an unknown platform and, without a card, `cuda`
    are refused before anything is written; serving on an unlisted device is
    refused with the artifact's platforms and the current device."""
    arts = {}
    for name, extra in (("default", []), ("cpu", ["--platforms", "cpu", "cpu"])):
        arts[name] = str(tmp_path / f"{name}.stbx")
        main(["export", "--config", "tiny", "--out", arts[name], "--output-size",
              *map(str, OUT_HW), "--device", "cpu", "--segment", "4", *extra])
        assert "platforms: cpu)" in capsys.readouterr().out
        blob, meta = load_artifact(arts[name])
        assert meta["platforms"] == ["cpu"] and list(meta["programs"]) == ["cpu"]
        (s0, sn), (g0, gn) = meta["programs"]["cpu"]["step"], meta["programs"]["cpu"]["segment"]
        assert (s0, g0, s0 + sn + gn) == (0, sn, len(blob))
    assert load_artifact(arts["default"])[0] == load_artifact(arts["cpu"])[0]

    engine = ExportedEngine.from_artifact(*load_artifact(arts["cpu"]), device="cpu")
    live = _engine()
    gray, color = _frames(1, 5, seed=6)
    want, got = live.init(gray[:, 0]), engine.init(gray[:, 0])
    for t in range(1, 5):
        want, w = live.step(want, gray[:, t], color[:, t])
        got, g = engine.step(got, gray[:, t], color[:, t])
        assert torch.equal(g.warped_color, w.warped_color) and torch.equal(g.black, w.black)
    assert torch.equal(got.frames, want.frames) and torch.equal(got.all_black, want.all_black)

    refusals = [(["tpu"], "no TPU program"), (["cpu", "rocm"], "unknown platform 'rocm'")]
    if not torch.cuda.is_available():
        refusals.append((["cpu", "cuda"], "a cuda program is made on a machine with a card"))
    for platforms, msg in refusals:
        out = str(tmp_path / "refused.stbx")
        with pytest.raises(SystemExit, match=msg):
            main(["export", "--config", "tiny", "--out", out, "--output-size",
                  *map(str, OUT_HW), "--device", "cpu", "--platforms", *platforms])
        assert not os.path.exists(out)
    with pytest.raises(SystemExit, match="artifact lowered for cpu; current device is cuda"):
        main(["stabilize", "--from-export", arts["cpu"], "--test-list",
              str(videos / "list.txt"), "--prefix", str(videos), "--output-dir",
              str(tmp_path / "x"), "--device", "cuda"])


def test_moved_program_keeps_nothing_on_the_traced_device(step_s1):
    """`move_to_device_pass` on the traced step: every weight and constant
    (the shape-keyed caches that the real call before tracing filled, K2m's
    tables among them) and every device baked into the graph lands on the
    target ("meta" stands in for a second device here)."""
    program = _moved(step_s1[1], "meta")
    tensors = list(program.state_dict.values()) + [
        v for v in program.constants.values() if isinstance(v, torch.Tensor)]
    assert tensors and all(t.device.type == "meta" for t in tensors)
    devices = [n.kwargs["device"] for n in program.graph.nodes if "device" in n.kwargs]
    assert devices and all(torch.device(d).type == "meta" for d in devices)
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            assert val.device.type == "meta", node


def test_first_layout_artifact_still_serves(batch_artifact, tmp_path):
    """An artifact whose header names one `device` and splits its payload
    at `step_len` (the layout before `--platforms`) loads and serves the
    chunked batch bit for bit as the live engine."""
    engine, step_data, seg_data = batch_artifact
    header = json.dumps({"format": "torch.export", "device": "cpu", "config": "tiny",
                         "out_hw": list(OUT_HW), "streams": 2, "refine": 1,
                         "step_len": len(step_data), "segment": 4}).encode()
    path = tmp_path / "first.stbx"
    path.write_bytes(_MAGIC + len(header).to_bytes(4, "little") + header
                     + step_data + seg_data)
    blob, meta = load_artifact(str(path))
    assert meta["platforms"] == ["cpu"]
    assert select_program(blob, meta, "cpu") == (step_data, seg_data)
    served = ExportedEngine.from_artifact(blob, meta, device="cpu")
    assert served.segment == 4 and hasattr(served, "continue_clip")
    clips = _clips()
    _assert_same(StreamDriver(served).stabilize_batch(clips),
                 StreamDriver(engine, DeployOptions()).stabilize_batch(clips, chunk=4))
