"""The port's compiled execution: the serving step and the flow as captured
CUDA graphs (stabnet_tpu_torch/utils/graphs.py), the JAX package's `jax.jit`
and `lax.scan` counterpart.

On the CPU: the capturable step body (`engine.capturable_step`: the ring
slot from a 0-d device `ptr`, writes in place, a device `valid` mask) against
the eager `stream_step` / `scan_frames`, bit for bit (the same operations on
the same values), and within the standing 1 uint8 LSB of the JAX engine's
XLA path with equal crop accumulators and crops; the engine's compiled scan
and its graph state (`_GraphState`: states copied in and their writes
copied back) run through the cache, which calls the body eagerly on the CPU;
the cache's key and the launch accounting as host functions; a CPU engine
and the CPU flow never capture.  TINY in f32, S=2 streams of T=12 frames
(the 4-slot ring wraps).

The `cuda` tests hold the graphs to the eager functions on a card with
`torch.equal`; they skip without one.  On a machine with a card and no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_compiled.py tests/test_torch_kernels.py
"""

import functools
import threading

import numpy as np
import pytest
import torch

from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.models import make_model, scale_theta_head
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.ops import flow as flow_ops
from stabnet_tpu_torch.stream import StreamEngine, crop_rectangle, video_io
from stabnet_tpu_torch.stream import engine as eng
from stabnet_tpu_torch.utils import graphs

torch.set_num_threads(1)

S, T, HF, WF = 2, 12, 96, 128


def _cfg():
    return get_config("tiny").replace(compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _clips():
    colors = np.stack([make_video(T, HF, WF, seed=s, jitter=4.0) for s in range(S)])
    cfg = _cfg()
    grays = np.stack([[video_io.to_gray_train(f, cfg.height, cfg.width,
                                              cfg.crop_rate if t == 0 else 1.0)
                       for t, f in enumerate(c)] for c in colors])
    return grays, colors


def _model(seed=0):
    return scale_theta_head(make_model(_cfg(), torch.Generator().manual_seed(seed)), 0.05)


def _prefix_valid():
    valid = np.ones((S, T - 1), bool)
    valid[1, 6:] = False
    return valid


def _eager_clip(model, cfg, grays, colors, refine, device_gray, valid, device="cpu"):
    """The eager reference: `stream_step` frame by frame from `init_state`,
    a False `valid` restoring the stream's slot and accumulator (as
    `scan_frames` masks).  Returns (per-step StepOutputs, final state)."""
    g = torch.from_numpy(grays).to(device)
    color_cf = torch.from_numpy(colors).to(device).permute(0, 1, 4, 2, 3).contiguous()
    state = eng.init_state(g[:, 0], cfg)
    outs = []
    for t in range(1, T):
        slot = state.ptr % state.frames.shape[1]
        old = (state.frames[:, slot].clone(), state.masks[:, slot].clone(),
               state.all_black.clone())
        state, out = eng.stream_step(model, state, None if device_gray else g[:, t],
                                     color_cf[:, t], cfg, refine=refine)
        if valid is not None:
            k3 = torch.from_numpy(valid[:, t - 1]).to(device)[:, None, None]
            state.frames[:, slot] = torch.where(k3, state.frames[:, slot], old[0])
            state.masks[:, slot] = torch.where(k3, state.masks[:, slot], old[1])
            state.all_black.copy_(torch.where(k3, state.all_black, old[2]))
        outs.append(out)
    return outs, state


@torch.inference_mode()
def _capturable_clip(model, cfg, grays, colors, refine, device_gray, valid):
    """`capturable_step` frame by frame on a state whose ptr is a 0-d
    tensor, written in place."""
    g = torch.from_numpy(grays)
    c = torch.from_numpy(colors)
    state0 = eng.init_state(g[:, 0], cfg)
    state = state0._replace(ptr=torch.tensor(state0.ptr, dtype=torch.int64))
    outs = []
    for t in range(1, T):
        outs.append(eng.capturable_step(
            model, state, None if device_gray else g[:, t], c[:, t], cfg, refine, (HF, WF),
            valid=None if valid is None else torch.from_numpy(valid[:, t - 1])))
    return outs, state


def _assert_states_equal(got, want):
    for f in ("frames", "masks", "all_black"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.ptr) == int(want.ptr)


@pytest.mark.parametrize("refine", [1, 2])
@pytest.mark.parametrize("device_gray", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_capturable_step_is_the_eager_step(refine, device_gray, with_valid):
    """Warped frames, every output, the ring, the crop accumulator and the
    crop: bit for bit."""
    cfg, model = _cfg(), _model()
    grays, colors = _clips()
    valid = _prefix_valid() if with_valid else None
    want, wstate = _eager_clip(model, cfg, grays, colors, refine, device_gray, valid)
    got, gstate = _capturable_clip(model, cfg, grays, colors, refine, device_gray, valid)
    for a, b in zip(got, want):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    _assert_states_equal(gstate, wstate)
    black = gstate.all_black.numpy()
    assert 0 < (black > 0).mean() < 0.5
    assert [crop_rectangle(b) for b in black] == [crop_rectangle(b)
                                                  for b in wstate.all_black.numpy()]


@pytest.mark.parametrize("with_valid", [False, True])
def test_capturable_step_is_scan_frames(with_valid):
    cfg, model = _cfg(), _model()
    grays, colors = _clips()
    valid = _prefix_valid() if with_valid else None
    state0 = eng.init_state(torch.from_numpy(grays[:, 0]), cfg)
    warped, wstate = eng.scan_frames(model, state0, torch.from_numpy(grays[:, 1:]),
                                     torch.from_numpy(colors[:, 1:]), cfg, valid=valid)
    got, gstate = _capturable_clip(model, cfg, grays, colors, 1, False, valid)
    assert torch.equal(torch.stack([o.warped_color for o in got], dim=1), warped)
    _assert_states_equal(gstate, wstate)


@pytest.mark.parametrize("refine", [1, 2])
@pytest.mark.parametrize("with_valid", [False, True])
def test_capturable_step_matches_jax(refine, with_valid):
    """Within 1 uint8 LSB of the JAX engine's XLA path (the frameworks round
    convolutions and solves differently in the last bits); the crop
    accumulator and the crops equal."""
    pytest.importorskip("jax")
    import jax

    from stabnet_tpu.config import get_config as jax_config
    from stabnet_tpu.models import init_variables, make_model as jax_make_model
    from stabnet_tpu.models import scale_theta_head as jax_scale_theta_head
    from stabnet_tpu.stream import StreamEngine as JaxStreamEngine
    from stabnet_tpu.stream.engine import crop_rectangle as jax_crop_rectangle
    from stabnet_tpu_torch.models import convert_flax_variables

    jcfg = jax_config("tiny").replace(compute_dtype="float32")
    jmodel = jax_make_model(jcfg)
    variables = jax_scale_theta_head(init_variables(jmodel, jcfg, jax.random.PRNGKey(0)),
                                     0.05)
    cfg = _cfg()
    model = make_model(cfg)
    model.load_state_dict(convert_flax_variables(variables))
    grays, colors = _clips()
    valid = _prefix_valid() if with_valid else None
    jw, jstate = JaxStreamEngine(jmodel, variables, jcfg, refine=refine,
                                 use_pallas=False).stabilize_clip(grays, colors, valid=valid)
    got, gstate = _capturable_clip(model.eval(), cfg, grays, colors, refine, False, valid)
    tw = torch.stack([o.warped_color for o in got], dim=1).numpy().astype(np.int32)
    jw = np.asarray(jw).astype(np.int32)
    if valid is not None:   # a frozen stream's outputs are discarded
        tw, jw = tw[valid], jw[valid]
    assert np.abs(tw - jw).max() <= 1
    jblack = np.asarray(jstate.all_black)
    np.testing.assert_array_equal(gstate.all_black.numpy(), jblack)
    for s in range(S):
        assert crop_rectangle(gstate.all_black[s].numpy()) == jax_crop_rectangle(jblack[s])


def test_compiled_scan_through_the_cache_is_scan_frames():
    """The engine's compiled scan on a CPU device: the cache calls the body
    eagerly on the graph state, so this runs every copy in and out of the
    card's path (load, the per-frame inputs, the result, store)."""
    cfg = _cfg()
    engine = StreamEngine(_model(), cfg, device="cpu")
    grays, colors = _clips()
    valid = _prefix_valid()
    want, wstate = engine.stabilize_clip(grays, colors, valid=valid)
    g, c = torch.from_numpy(grays), torch.from_numpy(colors)
    state = eng.init_state(g[:, 0], cfg)
    with torch.inference_mode():
        got, gstate = eng._run(engine._graph_scan(engine.model, state, g[:, 1:], c[:, 1:],
                                                  valid))
    assert torch.equal(got, want)
    _assert_states_equal(gstate, wstate)
    assert gstate.frames is state.frames    # written back in place
    assert len(engine.graphs) == 0          # a CPU device captures nothing


def test_graph_state_serves_states_in_turns():
    """Two streams stepped in turns through one graph state (each is copied
    in when the other was last, and its writes copied back) give what each
    gives alone, and a state keeps its own tensors."""
    cfg = _cfg()
    engine = StreamEngine(_model(), cfg, device="cpu")
    grays, colors = _clips()
    g, c = torch.from_numpy(grays[:1]), torch.from_numpy(colors[:1])
    g2, c2 = torch.from_numpy(grays[1:]), torch.from_numpy(colors[1:])
    with torch.inference_mode():
        alone = [eng._run(engine._graph_scan(engine.model, eng.init_state(x[:, 0], cfg),
                                             x[:, 1:], y[:, 1:], None))
                 for x, y in ((g, c), (g2, c2))]
        gs = engine._graph_state(engine.model, 1, engine.device)
        states = [eng.init_state(g[:, 0], cfg), eng.init_state(g2[:, 0], cfg)]
        frames = [[], []]
        for t in range(1, T):
            for i, (x, y) in enumerate(((g, c), (g2, c2))):
                gs.load(states[i])
                out = engine._replay(engine.model, gs, x[:, t], y[:, t])
                frames[i].append(out.warped_color.clone())
                states[i] = gs.store(states[i], 1)
    for i in range(2):
        assert torch.equal(torch.stack(frames[i], dim=1), alone[i][0])
        _assert_states_equal(states[i], alone[i][1])


def test_cpu_engine_and_flow_never_capture(monkeypatch):
    class NoGraph:
        def __init__(self, *a, **k):
            raise AssertionError("a CPU path attempted a CUDA graph capture")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    monkeypatch.setattr(torch.cuda, "graph", NoGraph)
    cfg = _cfg()
    engine = StreamEngine(_model(), cfg, device="cpu")
    grays, colors = _clips()
    state = engine.init(grays[:, 0])
    state, _ = engine.step(state, grays[:, 1], colors[:, 1])
    state, _ = engine.step(state, None, colors[:, 2])
    engine.continue_clip(state, grays[:, 3:5], colors[:, 3:5], valid=np.ones((S, 2), bool))
    engine.stabilize_clip(grays[:, :3], colors[:, :3])
    engine.stabilize_clips_sharded(grays[:, :3], colors[:, :3], devices=["cpu", "cpu"])
    n_flow = len(flow_ops.GRAPHS)
    a = torch.from_numpy(grays[0, 1:3])
    u = flow_ops.tvl1_flow(a, torch.from_numpy(grays[0, 2:4]), num_iters=2, fine_iters=2)
    assert torch.equal(u, flow_ops.tvl1_flow_eager(a, torch.from_numpy(grays[0, 2:4]),
                                                   num_iters=2, fine_iters=2))
    assert len(engine.graphs) == 0 and len(flow_ops.GRAPHS) == n_flow


def test_graph_key():
    """One graph per static arguments, device and input shapes and dtypes;
    an input's strides and the device it comes from do not matter."""
    x = torch.zeros((2, 3, 4))
    dev = torch.device("cuda", 0)
    key = graphs.signature(("k", 1), [x, x[0]], dev)
    assert key == graphs.signature(("k", 1), [x.permute(0, 2, 1).contiguous()
                                              .permute(0, 2, 1), x[1]], dev)
    assert key == graphs.signature(("k", 1), [x.to("meta"), x[0]], "cuda:0")
    assert key != graphs.signature(("k", 2), [x, x[0]], dev)
    assert key != graphs.signature(("k", 1), [x.double(), x[0]], dev)
    assert key != graphs.signature(("k", 1), [x[:1], x[0]], dev)
    assert key != graphs.signature(("k", 1), [x, x[0]], torch.device("cuda", 1))
    assert key != graphs.signature(("k", 1), [x], dev)


def test_cache_runs_the_function_eagerly_on_the_cpu():
    cache = graphs.GraphCache()
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b, a * b

    x, y = torch.arange(3.0), torch.full((3,), 2.0)
    for _ in range(2):
        s, p = cache("add", fn, (x, y), "cpu")
        assert torch.equal(s, x + y) and torch.equal(p, x * y)
    assert len(calls) == 2 and len(cache) == 0 and cache.stats() == []


def test_launches_are_counted_per_replay():
    """A launch while this thread records a capture goes into the record,
    not the counts; each replay adds the record once; another thread's
    launches count as they happen."""
    cuda_warp.reset_launch_counts()
    with cuda_warp.recording_launches() as record:
        cuda_warp._launched(cuda_warp.warp_mesh)
        cuda_warp._launched(cuda_warp.warp_uint8_cf_lowres)
        cuda_warp._launched(cuda_warp.warp_mesh)
        worker = threading.Thread(
            target=lambda: cuda_warp._launched(cuda_warp.bilinear_sample))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert record == {cuda_warp.warp_mesh: 2, cuda_warp.warp_uint8_cf_lowres: 1}
    assert [k.launches for k in cuda_warp.KERNELS] == [1, 0, 0, 0, 0, 0, 0, 0]
    for _ in range(3):
        cuda_warp.add_launches(record)
    assert cuda_warp.warp_mesh.launches == 6
    assert cuda_warp.warp_uint8_cf_lowres.launches == 3
    cuda_warp._launched(cuda_warp.warp_mesh)
    assert cuda_warp.warp_mesh.launches == 7
    cuda_warp.reset_launch_counts()


def test_recordings_nest_and_end():
    cuda_warp.reset_launch_counts()
    with cuda_warp.recording_launches() as outer:
        with cuda_warp.recording_launches() as inner:
            cuda_warp._launched(cuda_warp.bilinear_sample)
        cuda_warp._launched(cuda_warp.bilinear_splat)
    assert inner == {cuda_warp.bilinear_sample: 1}
    assert outer == {cuda_warp.bilinear_splat: 1}
    cuda_warp._launched(cuda_warp.sample_map_grad)
    assert cuda_warp.sample_map_grad.launches == 1
    assert cuda_warp.bilinear_sample.launches == 0
    cuda_warp.reset_launch_counts()


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [1, 2])
def test_card_graphs_equal_the_eager_step(card, refine):
    """The engine's graphs against `scan_frames` and `stream_step` on the
    card: warped frames, ring, accumulator, torch.equal; K1 and K2m launched
    once per frame (and refine pass), counted per replay."""
    cfg = _cfg()
    engine = StreamEngine(_model(), cfg, refine=refine, device=card)
    grays, colors = _clips()
    valid = _prefix_valid()
    cuda_warp.reset_launch_counts()
    w, st = engine.stabilize_clip(grays, colors, valid=valid)
    torch.cuda.synchronize()
    assert cuda_warp.warp_mesh.launches == refine * (T - 1)
    assert cuda_warp.warp_uint8_cf_lowres.launches == T - 1
    g, c = torch.from_numpy(grays).to(card), torch.from_numpy(colors).to(card)
    ww, wst = eng.scan_frames(engine.model, eng.init_state(g[:, 0], cfg), g[:, 1:],
                              c[:, 1:], cfg, refine=refine, valid=valid)
    assert torch.equal(w, ww)
    _assert_states_equal(st, wst)
    for device_gray in (False, True):
        want, wstate = _eager_clip(engine.model, cfg, grays[:1], colors[:1], refine,
                                   device_gray, None, device=card)
        state = engine.init(grays[:1, 0])
        for t in range(1, T):
            state, out = engine.step(state, None if device_gray else grays[:1, t],
                                     colors[:1, t])
            for f in out._fields:
                assert torch.equal(getattr(out, f), getattr(want[t - 1], f)), f
        _assert_states_equal(state, wstate)
    assert all(s["capture_s"] > 0 for s in engine.graphs.stats())


@pytest.mark.cuda
def test_card_step_output_outlives_the_next_step(card):
    cfg = _cfg()
    engine = StreamEngine(_model(), cfg, device=card)
    grays, colors = _clips()
    state = engine.init(grays[:, 0])
    kept = []
    for t in range(1, 5):
        state, out = engine.step(state, grays[:, t], colors[:, t])
        kept.append((out, [x.clone() for x in out]))
    torch.cuda.synchronize()
    for out, copy in kept:
        assert all(torch.equal(a, b) for a, b in zip(out, copy))
    assert not torch.equal(kept[-1][0].warped_color, kept[-2][0].warped_color)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [None, (144, 256)])
def test_card_flow_graph_equals_the_eager_flow(card, size):
    """The captured flow torch.equal the eager one, its launches per replay
    those of the schedule: at the clips' size every level on chip, at
    144x256 the finest level one K7 launch an iteration and the rest on
    chip, so both kernels run under capture."""
    if size is None:
        grays, _ = _clips()
    else:
        frames = make_video(3, *size, seed=5, jitter=4.0)
        grays = (frames.astype(np.float32).mean(-1) / 255.0)[None].repeat(2, 0)
    a = torch.from_numpy(np.ascontiguousarray(grays[:, 1])).to(card)
    b = torch.from_numpy(np.ascontiguousarray(grays[:, 2])).to(card)
    levels = flow_ops.tvl1_schedule(*a.shape, num_iters=10, fine_iters=5)
    assert [lv.onchip for lv in levels] == [size is None] + [True] * 3
    want = flow_ops.tvl1_flow_eager(a, b, num_iters=10, fine_iters=5)
    for _ in range(3):   # capture (runs eagerly), then replays
        cuda_warp.reset_launch_counts()
        got = flow_ops.tvl1_flow(a, b, num_iters=10, fine_iters=5)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert cuda_warp.bilinear_sample.launches == 20
        assert flow_ops.tvl1_iterate.launches == sum(lv.launches for lv in levels
                                                     if not lv.onchip)
        assert flow_ops.tvl1_iterate_n.launches == sum(lv.launches for lv in levels
                                                       if lv.onchip)
