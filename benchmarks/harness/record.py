"""The benchmark's own spans, and the record the per-layer readers read.

A span is a named interval on the host clock (`time.time()`, the clock the
profiler's events carry), recorded around a call into one layer of the
program.  In a traced run it is also a `torch.profiler.record_function`
range, so the profiler's timeline shows which span the host was in.  Spans
are kept in memory and only those inside the measured window are read.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Iterator, List, Optional, Tuple


class Recorder:
    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.spans: List[Tuple[str, float, float]] = []
        self.window: Tuple[float, float] = (0.0, 0.0)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.tracing:
            import torch

            ranged = torch.profiler.record_function(name)
        else:
            ranged = contextlib.nullcontext()
        with ranged:
            t0 = time.time()
            try:
                yield
            finally:
                self.spans.append((name, t0, time.time()))

    def open_window(self) -> None:
        self.spans.clear()
        self.window = (time.time(), 0.0)

    def close_window(self) -> None:
        self.window = (self.window[0], time.time())

    def summary(self) -> str:
        """Each span's count, mean, median and total in the window, for the
        run's standard error."""
        by: dict = {}
        for name, t0, t1 in self.spans:
            by.setdefault(name, []).append(t1 - t0)
        return "; ".join(f"{n} x{len(d)} mean {1e3 * sum(d) / len(d):.3f} ms "
                         f"p50 {1e3 * statistics.median(d):.3f} ms total {sum(d):.3f} s"
                         for n, d in by.items())

    def view(self, counters: dict, reduced: Optional[dict], device: dict, ctx) -> "Record":
        return Record(self.spans, counters, reduced, device, ctx, self.window)


class Record:
    """What a per-layer metric reads: the window's spans, the driver's
    counters, the traced timeline reduced to device operations (absent on
    the CPU), the device, and the cell's and configuration's entries."""

    def __init__(self, spans, counters: dict, reduced: Optional[dict], device: dict,
                 ctx, window: Tuple[float, float]):
        self.spans = spans
        self.counters = counters
        self.reduced = reduced
        self.device = device
        self.wl, self.cfg = ctx.wl, ctx.cfg
        self.window_start = window[0]
        self.window_s = window[1] - window[0]

    def span_durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]

    def span_median_ms(self, name: str) -> Optional[float]:
        d = self.span_durations(name)
        return statistics.median(d) * 1e3 if d else None

    def span_mean_ms(self, name: str) -> Optional[float]:
        d = self.span_durations(name)
        return sum(d) / len(d) * 1e3 if d else None

    @property
    def on_card(self) -> bool:
        return self.reduced is not None and self.device.get("platform") == "gpu"

    def kernel_times(self, match) -> List[float]:
        """Device seconds of each device operation whose name `match(name)`
        accepts, in the traced window; empty without a trace."""
        if not self.on_card:
            return []
        return [d for n, _, d in self.reduced["ops"] if match(n)]

    def idle_pct(self) -> Optional[float]:
        """Share of the traced window in which no device operation ran."""
        if not self.on_card or self.reduced["window_s"] <= 0:
            return None
        r = self.reduced
        return 100.0 * (1.0 - r["busy_s"] / r["window_s"])

    def peak_flops(self) -> Optional[float]:
        from benchmarks.harness.peaks import bf16_flops

        return bf16_flops(self.device.get("kind")) if self.on_card else None
