"""The reader of `pinned_share.batch` (`benchmarks/metrics/`) on synthetic
spans: the share of a batch call's host copy bytes that went through
page-locked buffers.

    python -m pytest benchmarks/tests/test_harness_pinned.py -q
"""

import pytest

from benchmarks.harness.main import load_metric
from benchmarks.tests.test_harness_spans import BENCH, kept, record, span  # noqa: F401

METRIC = load_metric("pinned_share.batch")


def test_declared():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "pinned_share.batch")
    assert m["workloads"] == ["serve-batch-720p"]
    assert m["moves"] == "device_ms_per_frame.batch" and m["layer"] == "engine and graphs"


def test_mixed_window_reads_its_share(kept):
    """Two calls, one upload half pageable: 300 of 400 bytes pinned."""
    kept.extend([span("driver.batch", 0, 2, 0, frames=360),
                  span("driver.scan", 0.5, 1.9, 1, parent=0),
                  span("engine.upload", 0.5, 0.6, 2, parent=1, pinned_bytes=50,
                       pageable_bytes=50),
                  span("driver.readback", 1.5, 1.8, 3, parent=1, pinned_bytes=100,
                       pageable_bytes=0),
                  span("driver.batch", 3, 5, 4, frames=360),
                  span("engine.upload", 3.5, 3.6, 5, parent=4, pinned_bytes=100,
                       pageable_bytes=0),
                  span("driver.readback", 4.5, 4.8, 6, parent=4, pinned_bytes=50,
                       pageable_bytes=50)])
    assert METRIC.read(record()) == pytest.approx(75.0)


def test_spans_outside_the_batch_count_nothing(kept):
    """A stream's upload, under no batch call, and a call before the window
    are left out: the window's one call reads 100 %."""
    kept.extend([span("driver.batch", 0, 2, 0, frames=360),
                 span("engine.upload", 0.5, 0.6, 1, parent=0, pinned_bytes=400,
                      pageable_bytes=0),
                 span("driver.readback", 1.5, 1.8, 2, parent=0, pinned_bytes=300,
                      pageable_bytes=0),
                 span("engine.upload", 3, 4, 3, pageable_bytes=10 ** 9, pinned_bytes=0),
                 span("driver.batch", -3, -1, 4, frames=360),
                 span("driver.readback", -2, -1.5, 5, parent=4, pageable_bytes=10 ** 9,
                      pinned_bytes=0)])
    assert METRIC.read(record()) == pytest.approx(100.0)


def test_none_without_the_counters(kept):
    """No spans, spans without the counters (a program that keeps none),
    or copies under no batch call: None."""
    assert METRIC.read(record()) is None
    kept.extend([span("driver.batch", 0, 2, 0, frames=360),
                 span("engine.upload", 0.5, 0.6, 1, parent=0),
                 span("driver.readback", 1.5, 1.8, 2, parent=0),
                 span("engine.upload", 3, 4, 3, pinned_bytes=10, pageable_bytes=0)])
    assert METRIC.read(record()) is None
