"""The port's spans and counters, on the profiler's clock, and the stage
timers built on them.

A span is one stage of the program as an interval of host time: its name,
its start and end as `time.time_ns()` (the clock `torch.profiler`'s events
carry), the index of its parent (the innermost span open on the same
thread, -1 for none), and a small dict of counters of the work done inside
it.  Counters hang on the span where the work happens, so a
reader that keeps a window's spans keeps its counters with them.

The switch is the profiler itself: spans are kept, in `TRACER`'s bounded
buffer, while `torch.autograd._profiler_enabled()` reads true (the C-level
flag that every Kineto profiler sets, `torch.profiler.profile` or a direct
`_enable_profiler`).  The flag is per thread: a profiler keeps the spans of
the thread it was started on.  A kept span is also a `record_function`
range, so a profiler trace shows the port's stages.  With no profiler a span
costs one flag check and keeps nothing.  Readers fetch the spans of a time
range (`Tracer.spans`), which reads None where the buffer dropped spans
that may have lain in the range.

`StageTimer` times named stages for the summaries the program reports (the
driver's fps and stage summary, the train loop's log), the reference's
signals (deploy fps every 10 frames and the data-read vs. train time every
100 iterations, deploy_bundle.py:285-287,316-318, train_bundle_nobm.py:
237-242); each stage is also a span, named with the timer's prefix.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

# Spans the buffer holds; the oldest go first.  A traced benchmark window
# keeps a few hundred.
CAPACITY = 100_000


class Span:
    """One kept stage: see the module's docstring."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "counters")

    def __init__(self, name: str, index: int, parent: int):
        self.name, self.index, self.parent = name, index, parent
        self.start_ns = self.end_ns = 0
        self.counters: Dict[str, float] = {}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}..{self.end_ns}, index={self.index}, "
                f"parent={self.parent}, counters={self.counters})")


class _Open:
    """The context of one kept span: its `record_function` range, and its
    place on the thread's stack of open spans."""

    __slots__ = ("tracer", "span", "ranged")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        stack = tracer._stack()
        self.span = Span(name, next(tracer._ids), stack[-1].index if stack else -1)
        self.ranged = torch.profiler.record_function(name)

    def __enter__(self) -> Span:
        self.ranged.__enter__()
        self.tracer._stack().append(self.span)
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        self.tracer._stack().pop()
        self.tracer._keep(self.span)
        self.ranged.__exit__(*exc)


_OFF = contextlib.nullcontext()


class Tracer:
    """A bounded buffer of kept spans, with the count of those it dropped."""

    def __init__(self, capacity: int = CAPACITY):
        self.buffer: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self.buffer) == self.buffer.maxlen:
                self.dropped += 1
            self.buffer.append(span)

    def span(self, name: str):
        """A context for the stage `name`: it yields the kept `Span` (whose
        `counters` the caller may fill) while the profiler runs, else None."""
        if not torch.autograd._profiler_enabled():
            return _OFF
        return _Open(self, name)

    def spans(self, start_ns: int, end_ns: int) -> Optional[List[Span]]:
        """The kept spans that started and ended within [start_ns, end_ns];
        None where a dropped span may have ended at or after `start_ns`
        (spans are kept in the order they end, so one dropped ended no
        later than the oldest kept)."""
        with self._lock:
            if self.dropped and self.buffer[0].end_ns >= start_ns:
                return None
            kept = list(self.buffer)
        return [s for s in kept if s.start_ns >= start_ns and s.end_ns <= end_ns]


TRACER = Tracer()
span = TRACER.span


class StageTimer:
    """Named stages, each timed for a summary and recorded as the span
    `prefix + name`.

    The streaming driver's per-frame latency decomposition
    ("pre"/"dispatch"/"readback", StreamDriver.stabilize_clip, and "net",
    one frame's dispatch plus its readback, which the pipelined mode
    issues after the next frame's dispatch); its batch call's "pre" and
    "scan".  On CUDA, "dispatch" measures the enqueue and "readback" the
    wait for the device.  The train loop's "data" (waiting for the next
    batch) and "step" (enqueueing a step, and waiting for the device when
    the loop reads the losses).
    """

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[Optional[Span]]:
        """Time the stage; yields its kept span, or None (see `Tracer.span`)."""
        with span(self.prefix + name) as kept:
            t0 = time.perf_counter()
            try:
                yield kept
            finally:
                self.samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Record a sample measured elsewhere (e.g. a sum of two stages)."""
        self.samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "total_s": float(a.sum()),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
            }
        return out

    def reset(self) -> None:
        self.samples.clear()
