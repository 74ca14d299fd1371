"""The port's last compiled units that one card can check: the metrics chunk
(`eval.metrics._pairs_h_chunk`, the JAX package's jitted chunk,
stabnet_tpu/eval/metrics.py:399-444) and the exported engine's step and
segment (`stream.export.ExportedEngine`, the JAX package's
`jax.jit(exported.call)`, stabnet_tpu/stream/export.py:159-164), each a
captured CUDA graph per static signature on the card (utils/graphs.py).

On the CPU, TINY shapes, seeded with numpy:
  * through `GraphLike`, a stand-in for the cache that keeps one set of
    input and output buffers per signature and returns the same output
    tensors at every call (as a graph does), the chunk is bit for bit
    `_pairs_h_chunk_eager` for each (prealign, rect) key, `_pairs_h` over
    three chunks is the eager chunks' result (each chunk copied out), and
    `evaluate_clip` stays within 1e-3 of the JAX package's per score
    (tests/test_torch_metrics.py's bound: the two flows differ by up to
    ~5e-3 px at a few pixels);
  * the chunk's key: the rect's values do not enter it, prealign and
    whether a rect is given do;
  * `ExportedEngine` through `GraphLike` and through the cache (which runs
    the program on the CPU) is bit for bit the loaded program
    (`load_stream_step`, or the segment program called directly) and the
    live engine: at S=1, two clips stepped in turns (each state foreign
    at its first call and after the other's, then held), and at S=2 on a
    2-frame segment with a prefix-valid mask, the tail padded, and a step
    after the segments on the same held state;
  * under a dispatch mode that fails on `aten._local_scalar_dense`, the
    chunk's body and the exported step and segment run without a read of
    a device value.

The `cuda` tests hold the graphs to the eager functions with `torch.equal`,
count the kernels' launches per replay and check that outputs outlive the
next call; they skip without a card.  On a machine with a card and no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_compiled_eval.py
"""

import functools
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.eval import metrics as tm
from stabnet_tpu_torch.models import make_model, scale_theta_head
from stabnet_tpu_torch.ops import cuda_warp
from stabnet_tpu_torch.stream import StreamEngine, video_io
from stabnet_tpu_torch.stream.export import (ExportedEngine, _load_program,
                                             export_scan_segment, export_stream_step,
                                             initial_state, load_stream_step)
from stabnet_tpu_torch.utils import graphs

torch.set_num_threads(1)

CFG = get_config("tiny")
OUT_HW = (2 * CFG.height, 2 * CFG.width)
RECT = (4.0, 5.0, 42.0, 58.0)
# The three keys of a scored clip (output and input stability, cross-video)
# and the cross-video key of a clip scored without a crop rect.
KEYS = [(True, True), (True, False), (False, True), (False, False)]


class GraphLike:
    """A stand-in for `GraphCache` that serves as its graphs do, on the CPU:
    per signature, one set of input buffers, which each call's inputs are
    copied into, and one set of output tensors, which `fn`'s results are
    written into and returned at every call."""

    def __init__(self):
        self.lock = threading.RLock()
        self._graphs = {}

    def __call__(self, key, fn, inputs, device):
        sig = graphs.signature(key, inputs, device)
        if sig not in self._graphs:
            static = [x.clone() for x in inputs]
            self._graphs[sig] = (static, tuple(fn(*static)))
            return self._graphs[sig][1]
        static, outs = self._graphs[sig]
        for dst, x in zip(static, inputs):
            dst.copy_(x)
        for dst, x in zip(outs, fn(*static)):
            dst.copy_(x)
        return outs


class NoDeviceRead(TorchDispatchMode):
    """Fails on every read of a tensor's value into Python."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a value was read from a tensor")
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _grays(T=11, seed=3):
    """(T, H, W) float32 gray frames at TINY's model scale of a shaky clip."""
    frames = make_video(T, *OUT_HW, seed=seed, jitter=3.0)
    return np.stack([video_io.to_gray_train(f, CFG.height, CFG.width) for f in frames])


def _pair(lo, hi, seed=3):
    g = torch.from_numpy(_grays(seed=seed))
    return g[lo:hi - 1], g[lo + 1:hi]


def _rect(r):
    return torch.tensor(r, dtype=torch.float32) if r is not None else None


# --- the metrics chunk ---------------------------------------------------------

@pytest.mark.parametrize("prealign,with_rect", KEYS)
def test_chunk_through_the_cache_is_the_eager_chunk(monkeypatch, prealign, with_rect):
    """Two chunks of 4 pairs through one graph-like signature (other frames
    and another rect the second time), and one through the cache itself:
    each bit for bit the eager chunk, the first still its own after the
    second call."""
    monkeypatch.setattr(tm, "GRAPHS", GraphLike())
    rects = [RECT, (3.0, 6.0, 40.0, 57.0)] if with_rect else [None, None]
    got, want = [], []
    for (lo, hi), r in zip(((0, 5), (4, 9)), rects):
        a, b = _pair(lo, hi)
        got.append(tm._pairs_h_chunk(a, b, _rect(r), prealign=prealign))
        want.append(tm._pairs_h_chunk_eager(a, b, _rect(r), prealign=prealign))
    assert len(tm.GRAPHS._graphs) == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])
    monkeypatch.undo()
    a, b = _pair(0, 5)
    assert torch.equal(tm._pairs_h_chunk(a, b, _rect(rects[0]), prealign=prealign), want[0])


def test_chunk_key_ignores_the_rect_values(monkeypatch):
    class Recording:
        lock = threading.RLock()
        keys = []

        def __call__(self, key, fn, inputs, device):
            self.keys.append(graphs.signature(key, inputs, "cuda:0"))
            return (torch.zeros((inputs[0].shape[0], 3, 3)),)

    monkeypatch.setattr(tm, "GRAPHS", Recording())
    a, b = _pair(0, 5)
    for prealign, r in ((True, RECT), (True, (0.0, 0.0, 47.0, 63.0)), (False, RECT),
                        (True, None), (False, None)):
        tm._pairs_h_chunk(a, b, _rect(r), prealign=prealign)
    tm._pairs_h_chunk(*_pair(0, 4), _rect(RECT), prealign=True)
    k = tm.GRAPHS.keys
    assert k[0] == k[1]                        # another rect, the same graph
    assert len(set(k[1:])) == 5                # prealign, a rect, the chunk's shape
    assert k[0][2][2] == ((4,), torch.float32)  # the rect is an input


def test_pairs_h_copies_each_chunk_out(monkeypatch):
    """`_pairs_h` over 3 chunks (4, 4 and a padded 2 pairs) through
    graph-like buffers: the eager chunks' homographies, not the last
    chunk's three times."""
    a, b = _pair(0, 11)
    want = []
    for s in range(0, 10, 4):
        ca, cb = a[s:s + 4], b[s:s + 4]
        k = ca.shape[0]
        ca = torch.cat([ca, ca[-1:].expand(4 - k, -1, -1)])
        cb = torch.cat([cb, cb[-1:].expand(4 - k, -1, -1)])
        want.append(tm._pairs_h_chunk_eager(ca, cb, _rect(RECT), prealign=True)[:k])
    monkeypatch.setattr(tm, "_EVAL_CHUNK", 4)
    monkeypatch.setattr(tm, "GRAPHS", GraphLike())
    got = tm._pairs_h(a, b, RECT, prealign=True)
    assert len(tm.GRAPHS._graphs) == 1
    assert torch.equal(got, torch.cat(want))


def test_evaluate_clip_through_the_graphs_matches_jax(monkeypatch):
    pytest.importorskip("jax")
    from stabnet_tpu.eval import metrics as jm
    from tests.test_torch_metrics import _shaky_pair

    monkeypatch.setattr(tm, "GRAPHS", GraphLike())
    inp, out = _shaky_pair()
    rect = (4, 5, 42, 58)
    want = jm.evaluate_clip(out, inp, rect=rect)
    got = tm.evaluate_clip(out, inp, rect=rect, device="cpu")
    assert len(tm.GRAPHS._graphs) == 2        # output stability, cross-video
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


@pytest.mark.parametrize("prealign,with_rect", KEYS)
def test_chunk_body_reads_nothing_from_the_device(prealign, with_rect):
    a, b = _pair(0, 5)
    with NoDeviceRead():
        h = tm._pairs_h_chunk_eager(a, b, _rect(RECT if with_rect else None),
                                    prealign=prealign)
    assert h.shape == (4, 3, 3)


# --- the exported engine -------------------------------------------------------

def _frames(S, T, seed):
    rng = np.random.RandomState(seed)
    gray = (rng.rand(S, T, CFG.height, CFG.width) - 0.5).astype(np.float32)
    color = rng.randint(0, 256, (S, T, *OUT_HW, 3), dtype=np.uint8)
    return gray, color


def _live(device="cpu"):
    model = scale_theta_head(make_model(CFG, torch.Generator().manual_seed(0)), 0.05)
    return StreamEngine(model, CFG, out_hw=OUT_HW, device=device)


@pytest.fixture(scope="module")
def programs():
    """The live engine, its S=1 step, and its S=2 step and 2-frame segment."""
    live = _live()
    return (live, export_stream_step(live, OUT_HW, streams=1),
            export_stream_step(live, OUT_HW, streams=2),
            export_scan_segment(live, OUT_HW, streams=2, segment=2))


def _assert_state(got, want):
    for f in ("frames", "masks", "all_black"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.ptr) == int(want.ptr)


@pytest.mark.parametrize("cache", ["graph_like", "cache"])
def test_exported_steps_in_turns_are_the_program(programs, cache):
    """Two S=1 clips stepped in turns through one engine (each state copied
    in at its first step and after each of the other's), then three more
    steps of the first on its held state: every output and state bit for
    bit the loaded program's and the live engine's on each clip alone."""
    live, step1 = programs[:2]
    program = load_stream_step(step1)
    engine = ExportedEngine(step1, CFG, OUT_HW, device="cpu")
    if cache == "graph_like":
        engine.graphs = GraphLike()
    clips = [_frames(1, 7, seed) for seed in (0, 1)]
    want, states, lives = [[], []], [], []
    for i, (gray, color) in enumerate(clips):
        state = initial_state(torch.from_numpy(gray[:, 0]), CFG)
        lstate = live.init(gray[:, 0])
        for t in range(1, 7):
            state, out = program(state, torch.from_numpy(gray[:, t]),
                                 torch.from_numpy(color[:, t]))
            lstate, lout = live.step(lstate, gray[:, t], color[:, t])
            assert torch.equal(out.warped_color, lout.warped_color)
            want[i].append(out)
        states.append(state)
        lives.append(lstate)
    got = [[], []]
    served = [engine.init(gray[:, 0]) for gray, _ in clips]
    order = [0, 1, 0, 1, 0, 1, 0, 0, 0, 1, 1, 1]
    for i in order:
        t = len(got[i]) + 1
        served[i], out = engine.step(served[i], clips[i][0][:, t], clips[i][1][:, t])
        got[i].append(out)
    for i in range(2):
        for g, w in zip(got[i], want[i]):
            for f in g._fields:
                assert torch.equal(getattr(g, f), getattr(w, f)), f
        _assert_state(served[i], states[i])
        _assert_state(served[i], lives[i])


def _eager_segments(seg_program, state, gray, color, valid, K):
    """The segment program called directly over frames 1.. in K-frame
    segments, the tail padded with invalid repeats of the last frame."""
    T = gray.shape[1]
    warped, t = [], 1
    while t < T:
        k = min(K, T - t)
        g, c, v = gray[:, t:t + k], color[:, t:t + k], valid[:, t - 1:t - 1 + k]
        if k < K:
            g = np.concatenate([g, np.repeat(g[:, -1:], K - k, axis=1)], axis=1)
            c = np.concatenate([c, np.repeat(c[:, -1:], K - k, axis=1)], axis=1)
            v = np.pad(v, [[0, 0], [0, K - k]])
        with torch.no_grad():
            res = seg_program(*state, *map(torch.from_numpy, (g, c, v)))
        warped.append(res[0][:, :k])
        state = type(state)(*res[1:])
        t += k
    return torch.cat(warped, dim=1), state


@pytest.mark.parametrize("cache", ["graph_like", "cache"])
def test_exported_segments_are_the_program(programs, cache):
    """S=2 with a 2-frame segment: `stabilize_clip` over 8 frames (3 full
    segments and a padded one, the second stream frozen after 4 steps) bit
    for bit the segment program called directly, and the live engine's
    `stabilize_clip` on every valid frame; then `continue_clip` and a step from a fresh
    state on one engine, each bit for bit the programs'."""
    live, _, step2, seg2 = programs
    engine = ExportedEngine(step2, CFG, OUT_HW, streams=2, scan_data=seg2, segment=2,
                            device="cpu")
    if cache == "graph_like":
        engine.graphs = GraphLike()
    gray, color = _frames(2, 8, seed=2)
    valid = np.arange(7)[None] < np.array([[7], [4]])
    state0 = initial_state(torch.from_numpy(gray[:, 0]), CFG)
    want, wstate = _eager_segments(_load_program(seg2), state0, gray, color, valid, 2)
    got, gstate = engine.stabilize_clip(gray, color, valid)
    assert torch.equal(got, want)
    assert torch.equal(gstate.all_black, wstate.all_black)
    lw, lstate = live.stabilize_clip(gray, color, valid)
    v = torch.from_numpy(valid)
    assert torch.equal(got[v], lw[v]) and torch.equal(gstate.all_black, lstate.all_black)

    state = engine.init(gray[:, 0])
    w1, state = engine.continue_clip(state, gray[:, 1:3], color[:, 1:3])
    state, out = engine.step(state, gray[:, 3], color[:, 3])
    w2, state = engine.continue_clip(state, gray[:, 4:6], color[:, 4:6])
    ref_w, ref = _eager_segments(_load_program(seg2), state0, gray[:, :3], color[:, :3],
                                 np.ones((2, 2), bool), 2)
    ref, ref_out = load_stream_step(step2)(ref, torch.from_numpy(gray[:, 3]),
                                           torch.from_numpy(color[:, 3]))
    ref_w2, ref = _eager_segments(_load_program(seg2), ref, gray[:, 3:6], color[:, 3:6],
                                  np.ones((2, 2), bool), 2)
    assert torch.equal(w1, ref_w) and torch.equal(w2, ref_w2)
    assert torch.equal(out.warped_color, ref_out.warped_color)
    _assert_state(state, ref)


def test_exported_bodies_read_nothing_from_the_device(programs):
    _, step1, step2, seg2 = programs
    gray, color = _frames(2, 4, seed=5)
    one = ExportedEngine(step1, CFG, OUT_HW, device="cpu")
    two = ExportedEngine(step2, CFG, OUT_HW, streams=2, scan_data=seg2, segment=2,
                         device="cpu")
    s1, s2 = one.init(gray[:1, 0]), two.init(gray[:, 0])
    with NoDeviceRead():
        s1, out = one.step(s1, gray[:1, 1], color[:1, 1])
        s1, out = one.step(s1, gray[:1, 2], color[:1, 2])
        w, s2 = two.continue_clip(s2, gray[:, 1:3], color[:, 1:3],
                                  valid=np.array([[True, True], [True, False]]))
        s2, _ = two.step(s2, gray[:, 3], color[:, 3])
    assert out.warped_color.shape == (1, *OUT_HW, 3) and w.shape == (2, 2, *OUT_HW, 3)


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("prealign,with_rect", KEYS)
def test_card_chunk_graph_equals_the_eager_chunk(card, prealign, with_rect):
    """Capture, then two replays on other frames and rects: torch.equal the
    eager chunk each time, 20 K2 launches per call (counted per replay),
    and each result still its own after the next call."""
    rects = [RECT, (3.0, 6.0, 40.0, 57.0), RECT] if with_rect else [None] * 3
    kept = []
    for (lo, hi), r in zip(((0, 5), (4, 9), (2, 7)), rects):
        a, b = (x.to(card) for x in _pair(lo, hi))
        want = tm._pairs_h_chunk_eager(a, b, None if r is None else _rect(r).to(card),
                                       prealign=prealign)
        cuda_warp.reset_launch_counts()
        got = tm._pairs_h_chunk(a, b, _rect(r), prealign=prealign)
        torch.cuda.synchronize()
        assert cuda_warp.bilinear_sample.launches == 20
        assert torch.equal(got, want)
        kept.append((got, want))
    for got, want in kept:
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def card_programs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    live = _live("cuda")
    return (live, export_stream_step(live, OUT_HW, streams=1),
            export_stream_step(live, OUT_HW, streams=2),
            export_scan_segment(live, OUT_HW, streams=2, segment=2))


@pytest.mark.cuda
def test_card_exported_graphs_equal_the_program(card_programs):
    """The S=1 step's graph and the S=2 segment's against the programs
    called eagerly on the card: torch.equal, K1 and K2m once per frame,
    each step's outputs still its own after the next."""
    live, step1, step2, seg2 = card_programs
    engine = ExportedEngine(step1, CFG, OUT_HW, device="cuda")
    program = load_stream_step(step1)
    gray, color = _frames(1, 6, seed=0)
    state = engine.init(gray[:, 0])
    ref = initial_state(torch.from_numpy(gray[:, 0]).cuda(), CFG)
    kept = []
    for t in range(1, 6):
        cuda_warp.reset_launch_counts()
        state, out = engine.step(state, gray[:, t], color[:, t])
        torch.cuda.synchronize()
        assert cuda_warp.warp_mesh.launches == 1
        assert cuda_warp.warp_uint8_cf_lowres.launches == 1
        ref, want = program(ref, torch.from_numpy(gray[:, t]).cuda(),
                            torch.from_numpy(color[:, t]).cuda())
        kept.append((out, want))
    for out, want in kept:
        for f in out._fields:
            assert torch.equal(getattr(out, f), getattr(want, f)), f
    _assert_state(state, ref)
    assert len(engine.graphs) == 1 and engine.graphs.stats()[0]["replays"] == 4

    engine = ExportedEngine(step2, CFG, OUT_HW, streams=2, scan_data=seg2, segment=2,
                            device="cuda")
    gray, color = _frames(2, 8, seed=2)
    valid = np.arange(7)[None] < np.array([[7], [4]])
    cuda_warp.reset_launch_counts()
    got, gstate = engine.stabilize_clip(gray, color, valid)
    torch.cuda.synchronize()
    assert cuda_warp.warp_mesh.launches == 8 and cuda_warp.warp_uint8_cf_lowres.launches == 8
    seg = _load_program(seg2)
    state0 = initial_state(torch.from_numpy(gray[:, 0]).cuda(), CFG)

    def on_card(program):
        def call(*args):
            return program(*(a.cuda() for a in args))
        return call

    want, wstate = _eager_segments(on_card(seg), state0, gray, color, valid, 2)
    assert torch.equal(got, want) and torch.equal(gstate.all_black, wstate.all_black)
