"""The reader of `tvl1_onchip_share.score` (the share of a scored clip's
TV-L1 pixel updates made by K7's on-chip launches) on synthetic spans, and
the counters a metrics chunk's schedule gives it.

    python -m pytest benchmarks/tests/test_harness_tvl1_onchip.py -q
"""

import json
import os
import types

import pytest

from benchmarks.harness.main import load_metric
from benchmarks.harness.record import Record
from stabnet_tpu_torch.ops.flow import tvl1_schedule
from stabnet_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")))
NAME = "tvl1_onchip_share.score"
T0 = 1_800_000_000.0          # the window's start, host seconds
CARD = "NVIDIA H100 80GB HBM3"
# A metrics chunk's counters: 32 pairs at 144x256, 100 iterations a warp.
CHUNK_PX, CHUNK_ONCHIP_PX = 778_240_000, 188_416_000


def span(name, a, b, index, parent=-1, **counters):
    s = profiling.Span(name, index, parent)
    s.start_ns, s.end_ns = int((T0 + a) * 1e9), int((T0 + b) * 1e9)
    s.counters.update(counters)
    return s


def record(window_s=10.0):
    ctx = types.SimpleNamespace(wl={}, cfg={})
    return Record([], {"frames": 65}, None, {"platform": "gpu", "kind": CARD}, ctx,
                  (T0, T0 + window_s))


@pytest.fixture
def kept(monkeypatch):
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tracer)
    return tracer.buffer


def test_metric_is_declared():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "%", "higher", "program_counter", "kernels", "scored_frames_per_s", ["score-720p"])


def test_counts_of_a_metrics_chunk():
    """The schedule's on-chip levels of a metrics chunk, (32, 72, 128),
    (32, 32, 64) and (32, 16, 32), update 188,416,000 of its 778,240,000
    pixels: 24.21 %."""
    levels = tvl1_schedule(32, 144, 256, fine_iters=100)
    assert sum(lv.px for lv in levels) == CHUNK_PX
    assert sum(lv.px for lv in levels if lv.onchip) == CHUNK_ONCHIP_PX
    assert round(100 * CHUNK_ONCHIP_PX / CHUNK_PX, 2) == 24.21


def test_reads_the_share_of_a_window(kept):
    """Two clips' chunks in the window: the share of their summed counters;
    a chunk outside the window does not count."""
    kept.extend([span("score.clip", 0.5, 4, 0),
                 span("score.pairs", 1, 2, 1, parent=0, tvl1_px=2 * CHUNK_PX,
                      tvl1_onchip_px=2 * CHUNK_ONCHIP_PX),
                 span("score.pairs", 2, 3, 2, parent=0, tvl1_px=CHUNK_PX,
                      tvl1_onchip_px=CHUNK_ONCHIP_PX),
                 span("score.clip", 5, 9, 3),
                 span("score.pairs", 6, 7, 4, parent=3, tvl1_px=CHUNK_PX,
                      tvl1_onchip_px=CHUNK_ONCHIP_PX),
                 span("score.pairs", -2, -1, 5, tvl1_px=10 ** 12, tvl1_onchip_px=0)])
    assert load_metric(NAME).read(record()) == pytest.approx(
        100 * CHUNK_ONCHIP_PX / CHUNK_PX, rel=1e-12)
    assert round(load_metric(NAME).read(record()), 2) == 24.21


def test_none_without_the_counter(kept):
    """No spans, or `score.pairs` spans without `tvl1_onchip_px` (a program
    without the on-chip launches, as the parent of the change that added
    them): None, never a raise."""
    metric = load_metric(NAME)
    assert metric.read(record()) is None
    kept.extend([span("score.clip", 0.5, 9, 0),
                 span("score.pairs", 1, 4, 1, parent=0, pairs=64, slots=64,
                      tvl1_px=CHUNK_PX, tvl1_launches=2000)])
    assert metric.read(record()) is None
