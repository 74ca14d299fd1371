"""The port's spans and counters (`stabnet_tpu_torch/utils/profiling.py`):
kept only under a profiler, on its clock, as a tree of the batch call's and
clip scoring's stages with their counters, in a bounded buffer."""

import functools
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.synthetic import make_video
from stabnet_tpu_torch.eval.metrics import score_stabilized_clip
from stabnet_tpu_torch.models import make_model
from stabnet_tpu_torch.stream import DeployOptions, StreamDriver, StreamEngine
from stabnet_tpu_torch.stream import video_io
from stabnet_tpu_torch.utils.profiling import TRACER, StageTimer, Tracer

CFG = get_config("tiny").replace(compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _driver():
    torch.manual_seed(0)
    return StreamDriver(StreamEngine(make_model(CFG), CFG, device="cpu"), DeployOptions())


def _clips():
    """Two clips of 5 frames: 8 stabilized frames."""
    return [make_video(5, 72, 96, seed=s, jitter=3.0) for s in range(2)]


def _traced(fn):
    """`fn()`'s result and the spans it kept under a CPU profiler, by name."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    by = {}
    for s in TRACER.spans(t0, t1):
        by.setdefault(s.name, []).append(s)
    return out, by


def test_no_profiler_keeps_nothing():
    before = len(TRACER.buffer)
    t0 = time.time_ns()
    got = _driver().stabilize_batch(_clips())
    assert TRACER.spans(t0, time.time_ns()) == [] and len(TRACER.buffer) == before
    summary = got[0].stage_summary
    assert set(summary) == {"pre", "scan"}
    for stage in summary.values():
        assert stage["count"] == 1
        assert {"count", "total_s", "mean_ms", "p50_ms"} <= set(stage)


def test_batch_span_tree():
    results, by = _traced(lambda: _driver().stabilize_batch(_clips()))
    parent = {"driver.batch": None, "driver.pre": "driver.batch",
              "driver.scan": "driver.batch", "driver.assemble": "driver.batch",
              "engine.upload": "driver.scan", "engine.scan": "driver.scan",
              "driver.readback": "driver.scan"}
    assert set(by) == set(parent)
    (root,) = by["driver.batch"]
    assert root.parent == -1 and root.counters == {"frames": 8}
    index = {s.index: s.name for spans in by.values() for s in spans}
    for name, spans in by.items():
        for s in spans:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
            if parent[name] is not None:
                assert index[s.parent] == parent[name], name
    # The stages' counters: the grays' and color copies' seconds within
    # "pre", which the timer's summary reads as before.
    (pre,) = by["driver.pre"]
    c = pre.counters
    assert set(c) == {"gray_s", "color_s"} and c["gray_s"] > 0 and c["color_s"] > 0
    assert c["gray_s"] + c["color_s"] <= (pre.end_ns - pre.start_ns) * 1e-9
    assert results[0].stage_summary["pre"]["count"] == 1
    assert len(by["driver.readback"]) == 2     # the frames and the black counts


def test_score_pairs_and_slots():
    out = make_video(9, 96, 128, seed=4, jitter=0.5)
    inp = make_video(9, 96, 128, seed=4, jitter=2.0)
    in_gray = np.stack([video_io.to_gray_train(f, 48, 64) for f in inp])
    scores, by = _traced(lambda: score_stabilized_clip(out, in_gray, (48, 64),
                                                       crop_rect=(3, 4, 44, 60),
                                                       device="cpu"))
    assert set(by) == {"score.clip", "score.grays", "score.pairs", "score.reduce"}
    (clip,) = by["score.clip"]
    assert clip.parent == -1 and clip.counters == {}
    for name in ("score.grays", "score.pairs", "score.reduce"):
        assert all(s.parent == clip.index for s in by[name]), name
    # 8 inter-frame pairs of the output, 9 cross-video and 8 of the input,
    # each call's pairs padded to whole chunks of 32.
    pairs = by["score.pairs"]
    assert [s.counters["pairs"] for s in pairs] == [8, 9, 8]
    assert sum(s.counters["pairs"] for s in pairs) == 25
    assert sum(s.counters["slots"] for s in pairs) == 96
    assert len(by["score.reduce"]) == 2 + 1
    assert 0 < scores["stability"] <= 1


def test_span_on_profiler_clock():
    """A span's start lies within 1 ms of its `record_function` event's,
    both on the host's `time.time_ns()`."""
    timer = StageTimer("test.")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("warm"):      # the profiler's first range costs more
            pass
        t0 = time.time_ns()
        with timer.stage("clock") as kept:
            torch.ones(8).sum()
    assert kept is not None and kept.start_ns >= t0
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "test.clock"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - kept.start_ns) < 1_000_000
    assert timer.summary()["clock"]["count"] == 1


def test_buffer_counts_what_it_drops():
    tracer = Tracer(capacity=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with tracer.span(f"s{k}") as kept:
                kept.counters["k"] = k
            time.sleep(0.001)
    assert tracer.dropped == 2
    assert [s.name for s in tracer.buffer] == ["s2", "s3", "s4"]
    # A range that may have held a dropped span reads None, one after the
    # oldest kept span's end reads what it holds.
    s2, s3, s4 = tracer.buffer
    assert tracer.spans(0, s4.end_ns) is None
    assert tracer.spans(s2.end_ns, s4.end_ns) is None
    assert tracer.spans(s2.end_ns + 1, s4.end_ns) == [s3, s4]
    # Without a profiler the tracer keeps nothing and yields no span.
    with tracer.span("off") as kept:
        assert kept is None
    assert tracer.dropped == 2 and len(tracer.buffer) == 3


def test_nested_spans_name_their_parent():
    tracer = Tracer()
    other = []

    def on_thread():
        with tracer.span("thread") as kept:
            other.append(kept)

    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("outer") as outer:
            with tracer.span("inner") as inner:
                worker = threading.Thread(target=on_thread)
                worker.start()
                worker.join(timeout=60)
        with tracer.span("next") as nxt:
            pass
    assert not worker.is_alive()
    assert outer.parent == -1 and inner.parent == outer.index and nxt.parent == -1
    # The profiler's flag is per thread: one started on this thread keeps
    # no span of another.
    assert other == [None] and len(tracer.buffer) == 3
    assert tracer.spans(outer.start_ns, outer.end_ns) == [inner, outer]


def test_clip_stages_are_not_the_batch_calls():
    """The per-frame path's stages carry their own prefix, so a window that
    also runs it keeps no `driver.pre` or `driver.readback` but the batch
    call's."""
    drv = _driver()
    clip = _clips()[0]
    _, by = _traced(lambda: (drv.stabilize_clip(clip), drv.stabilize_batch([clip])))
    assert {"driver.clip.pre", "driver.clip.dispatch", "driver.clip.readback"} <= set(by)
    (root,) = by["driver.batch"]
    index = {s.index: s for spans in by.values() for s in spans}
    for name in ("driver.pre", "driver.readback"):
        for s in by[name]:
            while s.parent != -1:
                s = index[s.parent]
            assert s is root, name
