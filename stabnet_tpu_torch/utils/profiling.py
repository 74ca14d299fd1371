"""Per-stage wall-clock timing (the reference prints deploy fps every 10
frames and the data-read vs. train time every 100 iterations,
deploy_bundle.py:285-287,316-318, train_bundle_nobm.py:237-242; here the
same signals are a summary).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np


class StageTimer:
    """Named per-stage timers with percentile summaries.

    The streaming driver's per-frame latency decomposition
    ("pre"/"dispatch"/"readback", StreamDriver.stabilize_clip, and "net",
    one frame's dispatch plus its readback, which the pipelined mode
    issues after the next frame's dispatch).  On CUDA, "dispatch"
    measures the enqueue and "readback" the wait for the device.  The train
    loop's "data" (waiting for the next batch) and "step" (enqueueing a
    step, and waiting for the device when the loop reads the losses).
    """

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
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
