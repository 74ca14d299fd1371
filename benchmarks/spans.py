"""The program's own spans and counters in a run's measured window, and the
device's idle time put down to them.

The port keeps its spans (`stabnet_tpu_torch/utils/profiling.py`, `TRACER`)
while the profiler runs, on the host clock the profiler's events carry, each
with its parent and the counters of the work done inside it.  A reader here
keeps those that started and ended inside the window under a root span (one
batch call, one scored clip); where the program keeps none (a checkout
without the tracer, or no profiler), or its buffer dropped spans of the
window, every function reads None.

The idle time of a named span is that of its self intervals: the span's
intervals less those of its children in the program, so the innermost span
wins, intersected with the window's stretches in which no device operation
ran (the complement of the union of `rec.reduced["ops"]`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from benchmarks.harness.trace import merge

Interval = Tuple[float, float]


def program_spans(rec, root: str) -> Optional[list]:
    """The program's kept spans inside the window that lie under a span
    named `root` (it included), so that a stage the program runs elsewhere
    too (an engine's upload in a stream) counts only in the calls a metric
    reads; None where it keeps none, or where its buffer dropped spans of
    the window."""
    try:
        from stabnet_tpu_torch.utils.profiling import TRACER
    except ImportError:
        return None
    w0 = int(rec.window_start * 1e9)
    kept = TRACER.spans(w0, w0 + int(rec.window_s * 1e9)) or []
    by = {s.index: s for s in kept}
    under: dict = {}

    def inside(s) -> bool:
        if s.index not in under:
            up = by.get(s.parent)
            under[s.index] = s.name == root or (up is not None and inside(up))
        return under[s.index]

    return [s for s in kept if inside(s)] or None


def total(spans: Sequence, name: str, counter: Optional[str] = None) -> float:
    """The summed `counter` of the spans named `name`, or, without one,
    their summed seconds."""
    if counter is None:
        return sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-9
    return sum(s.counters.get(counter, 0) for s in spans if s.name == name)


def ms_per(rec, name: str, counter: Optional[str], per: Tuple[str, str]) -> Optional[float]:
    """`total(name, counter)` in ms over the total of the counter `per`
    (span name, counter), e.g. seconds of "driver.assemble" per
    ("driver.batch", "frames"), over the spans under `per`'s span."""
    spans = program_spans(rec, per[0])
    if spans is None or not any(s.name == name for s in spans):
        return None
    base = total(spans, *per)
    return total(spans, name, counter) / base * 1e3 if base else None


def subtract(intervals: List[Interval], cuts: List[Interval]) -> List[Interval]:
    """`intervals` less the union of `cuts`, both sorted and disjoint."""
    out, k = [], 0
    for a, b in intervals:
        while k < len(cuts) and cuts[k][1] <= a:
            k += 1
        j = k
        while j < len(cuts) and cuts[j][0] < b:
            if cuts[j][0] > a:
                out.append((a, cuts[j][0]))
            a = max(a, cuts[j][1])
            j += 1
        if a < b:
            out.append((a, b))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def self_intervals(spans: Sequence, name: str) -> List[Interval]:
    """The intervals (host seconds) of the spans named `name`, less those
    of their children, sorted and disjoint."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.start_ns * 1e-9, s.end_ns * 1e-9))
    out: List[Interval] = []
    for s in spans:
        if s.name == name:
            out += subtract([(s.start_ns * 1e-9, s.end_ns * 1e-9)],
                            merge(kids.get(s.index, [])))
    return merge(out)


def idle_share(rec, name: str, root: str) -> Optional[float]:
    """The share of the window's device-idle time that falls in the self
    intervals of the spans named `name` under a span named `root`, in %;
    None without a trace, or where no such span was kept."""
    if not rec.on_card:
        return None
    spans = program_spans(rec, root)
    if not spans or not any(s.name == name for s in spans):
        return None
    r = rec.reduced
    w0 = rec.window_start
    w1 = w0 + r["window_s"]
    idle_s = r["window_s"] - r["busy_s"]
    if idle_s <= 0:
        return None
    busy = merge([(max(s, w0), min(s + d, w1)) for _, s, d in r["ops"] if s + d > w0 and s < w1])
    mine = [(max(a, w0), min(b, w1)) for a, b in self_intervals(spans, name) if b > w0 and a < w1]
    return 100.0 * length(subtract(mine, busy)) / idle_s
