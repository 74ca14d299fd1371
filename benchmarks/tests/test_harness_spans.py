"""The readers of the program's spans (`benchmarks/spans.py`) and the
per-layer metrics built on them, on synthetic timelines.

    python -m pytest benchmarks/tests/test_harness_spans.py -q
"""

import json
import os
import types

import pytest

from benchmarks import spans
from benchmarks.harness.main import load_metric
from benchmarks.harness.record import Record
from stabnet_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")))
NAMES = ("gray_ms_per_frame.batch", "color_ms_per_frame.batch",
         "assemble_ms_per_frame.batch", "upload_ms_per_frame.batch",
         "readback_ms_per_frame.batch", "idle_pre_share.batch",
         "idle_assemble_share.batch", "chunk_fill.score", "idle_pairs_share.score",
         "idle_reduce_share.score")
NEW = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NAMES}
T0 = 1_800_000_000.0          # the window's start, host seconds


def span(name, a, b, index, parent=-1, **counters):
    """A kept span from `a` to `b` seconds after the window's start."""
    s = profiling.Span(name, index, parent)
    s.start_ns, s.end_ns = int((T0 + a) * 1e9), int((T0 + b) * 1e9)
    s.counters.update(counters)
    return s


def record(ops=None, window_s=10.0):
    """A run's record of a `window_s` window from T0; `ops` are device
    operations (start, end) in seconds after T0, None for no trace."""
    reduced = None
    if ops is not None:
        busy = sum(b - a for a, b in ops)
        reduced = {"ops": [("op", T0 + a, b - a) for a, b in ops], "busy_s": busy,
                   "window_s": window_s, "device_ops": [], "idle_gaps": []}
    ctx = types.SimpleNamespace(wl={}, cfg={})
    return Record([], {}, reduced, {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"},
                  ctx, (T0, T0 + window_s))


@pytest.fixture
def kept(monkeypatch):
    """The program's tracer, emptied; the test fills its buffer."""
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tracer)
    return tracer.buffer


def test_metrics_are_declared():
    """Each reads one cell's spans and moves that cell's end-to-end metric."""
    assert set(NEW) == set(NAMES)
    for name, m in NEW.items():
        cell = "serve-batch-720p" if name.endswith(".batch") else "score-720p"
        moves = "device_ms_per_frame.batch" if cell == "serve-batch-720p" else "scored_frames_per_s"
        assert m["workloads"] == [cell] and m["moves"] == moves, name


def test_subtract():
    assert spans.subtract([(0, 10)], [(1, 2), (4, 5)]) == [(0, 1), (2, 4), (5, 10)]
    assert spans.subtract([(0, 3), (5, 8)], [(2, 6)]) == [(0, 2), (6, 8)]
    assert spans.subtract([(1, 2)], [(0, 5)]) == []
    assert spans.subtract([(1, 2)], []) == [(1, 2)]


def test_idle_cut_by_parent_and_child(kept):
    """A parent [0.5, 9] with a child [3, 8], device busy [1, 2] and [6, 7]
    of a 10 s window (8 s idle): the parent's self time is [0.5, 3] and
    [8, 9], of it 2.5 s idle; the child's [3, 8], 4 s idle.  The innermost
    span wins, and a span outside the window, or under no root, counts
    nothing."""
    kept.extend([span("driver.assemble", 3, 8, 1, parent=0),
                 span("driver.pre", 0.5, 9, 0, parent=4),
                 span("driver.batch", 0, 9.5, 4),
                 span("driver.pre", 9.6, 9.9, 5),
                 span("driver.pre", -3, -1, 2),
                 span("driver.pre", 10.5, 12, 3)])
    rec = record(ops=[(1, 2), (6, 7)])
    assert spans.idle_share(rec, "driver.pre", "driver.batch") == pytest.approx(
        100 * 2.5 / 8, abs=1e-4)
    assert spans.idle_share(rec, "driver.assemble", "driver.batch") == pytest.approx(
        100 * 4 / 8, abs=1e-4)
    assert load_metric("idle_pre_share.batch").read(rec) == pytest.approx(31.25, abs=1e-4)
    assert load_metric("idle_assemble_share.batch").read(rec) == pytest.approx(50, abs=1e-4)
    assert spans.idle_share(rec, "score.pairs", "score.clip") is None
    # Without the root the same stage reads its idle time outside the calls.
    assert spans.idle_share(rec, "driver.pre", "driver.pre") == pytest.approx(
        100 * 2.8 / 8, abs=1e-4)


def test_ms_per_frame_from_counters_and_spans(kept):
    kept.extend([span("driver.batch", 0, 4, 0, frames=360),
                 span("driver.pre", 0, 1.8, 1, parent=0, gray_s=0.9, color_s=0.72),
                 span("driver.assemble", 3.5, 3.86, 2, parent=0),
                 span("driver.scan", 1.8, 3.1, 4, parent=0),
                 span("engine.upload", 1.8, 2.0, 3, parent=4),
                 span("driver.readback", 2.5, 3.0, 5, parent=4),
                 span("driver.readback", 3.0, 3.04, 6, parent=4),
                 span("driver.batch", -2, -1, 7, frames=1000),
                 # A stream's upload, under no batch call, is not the batch's.
                 span("engine.upload", 5, 6, 8)])
    rec = record()
    got = {n: load_metric(n).read(rec) for n in NEW if n.endswith("ms_per_frame.batch")}
    assert got == pytest.approx({"gray_ms_per_frame.batch": 2.5,
                                 "color_ms_per_frame.batch": 2.0,
                                 "assemble_ms_per_frame.batch": 1.0,
                                 "upload_ms_per_frame.batch": 0.2 / 360 * 1e3,
                                 "readback_ms_per_frame.batch": 0.54 / 360 * 1e3}, rel=1e-5)


def test_chunk_fill(kept):
    """193 pairs of a 65-frame clip in 7 chunks of 32: 86.16 %; a span
    before the window is left out."""
    kept.extend([span("score.pairs", 0.1, 0.2, 1, parent=0, pairs=64, slots=64),
                 span("score.pairs", 0.3, 0.4, 2, parent=0, pairs=65, slots=96),
                 span("score.pairs", 0.5, 0.6, 3, parent=0, pairs=64, slots=64),
                 span("score.clip", 0, 0.7, 0),
                 span("score.pairs", -0.5, -0.4, 4, pairs=1, slots=32),
                 # `evaluate_clip` called alone, under no clip scoring.
                 span("score.pairs", 0.8, 0.9, 5, pairs=1, slots=32)])
    assert load_metric("chunk_fill.score").read(record()) == pytest.approx(
        100 * 193 / 224, abs=1e-9)


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_spans_or_trace(kept, name):
    metric = load_metric(name)
    assert metric.read(record()) is None
    assert metric.read(record(ops=[(1, 2)])) is None
    kept.extend([span("driver.batch", 0, 4, 0, frames=360),
                 span("driver.pre", 0, 1, 1, parent=0, gray_s=0.5, color_s=0.4),
                 span("driver.assemble", 3, 4, 2, parent=0),
                 span("engine.upload", 1, 2, 3, parent=0),
                 span("driver.readback", 2, 3, 4, parent=0),
                 span("score.clip", 5, 9, 5),
                 span("score.pairs", 5, 6, 6, parent=5, pairs=65, slots=96),
                 span("score.reduce", 6, 7, 7, parent=5)])
    if NEW[name]["source"] == "device_trace":
        assert metric.read(record()) is None
        assert metric.read(record(ops=[(1, 2)])) is not None
    else:
        assert metric.read(record()) is not None


def test_program_spans_reads_the_window():
    """The program's own tracer under a CPU profiler: the window's spans,
    not those before it."""
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("test.before"):
            pass
        start = time.time()
        with profiling.span("test.inside") as inside:
            inside.counters["n"] = 3
        rec = Record([], {}, None, {"platform": "cpu"},
                     types.SimpleNamespace(wl={}, cfg={}), (start, time.time()))
    got = spans.program_spans(rec, "test.inside")
    assert [s.name for s in got] == ["test.inside"] and got[0].counters == {"n": 3}


def test_none_where_spans_were_dropped(monkeypatch):
    """A window that may have lost spans to the buffer's bound reads None;
    one after the dropped spans reads what it holds."""
    tracer = profiling.Tracer(capacity=3)
    monkeypatch.setattr(profiling, "TRACER", tracer)
    for s in (span("driver.batch", 0.5, 1, 0, frames=10),
              span("driver.clip.pre", 1.1, 1.2, 1),
              span("driver.assemble", 2, 3, 2, parent=3),
              span("driver.batch", 1.5, 3.5, 3, frames=20)):
        tracer._keep(s)
    assert tracer.dropped == 1
    metric = load_metric("assemble_ms_per_frame.batch")
    assert metric.read(record()) is None
    assert metric.read(Record([], {}, None, {"platform": "gpu"},
                              types.SimpleNamespace(wl={}, cfg={}),
                              (T0 + 1.3, T0 + 4))) == pytest.approx(50.0)


def test_clip_and_stream_leave_the_batch_metrics():
    """The program's per-frame and streaming paths, run in the window beside
    a batch call, change none of the batch call's metrics."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from stabnet_tpu_torch.config import get_config
    from stabnet_tpu_torch.data.synthetic import make_video
    from stabnet_tpu_torch.models import make_model
    from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine, video_io

    cfg = get_config("tiny").replace(compute_dtype="float32")
    drv = StreamDriver(StreamEngine(make_model(cfg), cfg, device="cpu"), DeployOptions())
    clip = make_video(5, 72, 96, seed=0, jitter=3.0)
    ctx = types.SimpleNamespace(wl={}, cfg={})
    with profile(activities=[ProfilerActivity.CPU]):
        w0 = time.time()
        drv.stabilize_clip(clip)
        b0 = time.time()
        drv.stabilize_batch([clip])
        b1 = time.time()
        drv.stabilize_stream(video_io.ArrayVideoReader(clip), video_io.ArrayVideoWriter(), 2)
        w1 = time.time()
    names = {s.name for s in profiling.TRACER.spans(int(w0 * 1e9), int(w1 * 1e9))}
    assert {"driver.clip.pre", "driver.clip.readback", "engine.upload"} <= names
    batch_only = Record([], {}, None, {"platform": "cpu"}, ctx, (b0, b1))
    everything = Record([], {}, None, {"platform": "cpu"}, ctx, (w0, w1))
    for name in NAMES:
        if name.endswith("ms_per_frame.batch"):
            metric = load_metric(name)
            got = metric.read(batch_only)
            assert got is not None and metric.read(everything) == got, name
