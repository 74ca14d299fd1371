"""K7's roofline counts (`benchmarks/roofline/tvl1.py`) and the readers of
its metrics (`tvl1_roofline`, `tvl1_ms_per_frame.score`) on synthetic
timelines.

    python -m pytest benchmarks/tests/test_harness_tvl1.py -q
"""

import json
import os
import types

import pytest

from benchmarks.harness.main import load_metric
from benchmarks.harness.record import Record
from benchmarks.roofline import least_seconds, tvl1
from stabnet_tpu_torch.ops.flow import tvl1_schedule
from stabnet_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")))
NAMES = ("tvl1_roofline", "tvl1_ms_per_frame.score")
T0 = 1_800_000_000.0          # the window's start, host seconds
CARD = "NVIDIA H100 80GB HBM3"
KERNEL = "(anonymous namespace)::tvl1_iterate_kernel(float const*, float const*)"


def span(name, a, b, index, parent=-1, **counters):
    s = profiling.Span(name, index, parent)
    s.start_ns, s.end_ns = int((T0 + a) * 1e9), int((T0 + b) * 1e9)
    s.counters.update(counters)
    return s


def record(ops=None, frames=65, window_s=10.0):
    """A run's record; `ops` are device operations (name, start, seconds)
    after T0, None for no trace."""
    reduced = None
    if ops is not None:
        reduced = {"ops": [(n, T0 + a, d) for n, a, d in ops],
                   "busy_s": sum(d for _, _, d in ops), "window_s": window_s,
                   "device_ops": [], "idle_gaps": []}
    ctx = types.SimpleNamespace(wl={}, cfg={})
    return Record([], {"frames": frames}, reduced, {"platform": "gpu", "kind": CARD}, ctx,
                  (T0, T0 + window_s))


@pytest.fixture
def kept(monkeypatch):
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tracer)
    return tracer.buffer


def test_metrics_are_declared():
    new = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NAMES}
    assert set(new) == set(NAMES)
    assert new["tvl1_roofline"]["layer"] == "kernels"
    assert new["tvl1_ms_per_frame.score"]["layer"] == "flow and metrics"
    for m in new.values():
        assert m["workloads"] == ["score-720p"] and m["moves"] == "scored_frames_per_s"


def test_counts_of_a_metrics_chunk():
    """A metrics chunk's flow, 32 pairs at 144x256 with 100 iterations a
    warp everywhere: 778,240,000 pixel updates over 2,000 launches, 60 B
    and 58 operations each; bound by the bytes at 13.94 ms."""
    levels = tvl1_schedule(32, 144, 256, fine_iters=100)
    px = sum(lv.warps * lv.iters * lv.shape[0] * lv.shape[1] * lv.shape[2] for lv in levels)
    assert px == 778_240_000 and sum(lv.warps * lv.iters for lv in levels) == 2000
    assert tvl1.nbytes(px) == 46_694_400_000 and tvl1.ops(px) == 45_137_920_000
    assert least_seconds(tvl1.nbytes(px), tvl1.ops(px), CARD) == pytest.approx(
        46_694_400_000 / 3.35e12)


def test_readers_on_a_window(kept):
    """Two chunks' iterations in the window's one clip and four launches of
    7, 8, 9 and 36 us: the least time per launch over the mean, and the
    launches' time per scored frame."""
    kept.extend([span("score.clip", 0.5, 9, 0),
                 span("score.pairs", 1, 4, 1, parent=0, pairs=64, slots=64,
                      tvl1_px=1_556_480_000, tvl1_launches=4000),
                 # A chunk outside the window does not count.
                 span("score.pairs", -2, -1, 2, tvl1_px=10 ** 12, tvl1_launches=1)])
    ops = [(KERNEL, 1.0, 7e-6), (KERNEL, 1.1, 8e-6), ("elementwise_kernel", 1.2, 5e-6),
           (KERNEL, 1.3, 9e-6), (KERNEL, 1.4, 36e-6)]
    rec = record(ops)
    least = 60 * 1_556_480_000 / 3.35e12 / 4000
    assert load_metric("tvl1_roofline").read(rec) == pytest.approx(
        100 * least / 15e-6, rel=1e-9)
    assert load_metric("tvl1_ms_per_frame.score").read(rec) == pytest.approx(
        60e-6 / 65 * 1e3, rel=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_none_where_nothing_to_read(kept, name):
    """No trace, no K7 launch (a program without the kernel), or no
    counters on the spans (a program without them): None, never a raise."""
    metric = load_metric(name)
    assert metric.read(record()) is None
    assert metric.read(record(ops=[("elementwise_kernel", 1.0, 5e-6)])) is None
    kept.extend([span("score.clip", 0.5, 9, 0), span("score.pairs", 1, 4, 1, parent=0,
                                                     pairs=64, slots=64)])
    assert metric.read(record(ops=[("elementwise_kernel", 1.0, 5e-6)])) is None
    assert metric.read(record(ops=[(KERNEL, 1.0, 5e-6)], frames=0)) is None
    if name == "tvl1_roofline":
        assert metric.read(record(ops=[(KERNEL, 1.0, 5e-6)])) is None
