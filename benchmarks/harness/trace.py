"""The traced window: `torch.profiler`'s Kineto timeline, reduced.

The profiler is driven through its Kineto entry points (`_enable_profiler`,
`_disable_profiler`), whose result lists the raw events: the public
`torch.profiler.profile` would also build a Python object per event at its
stop, which for the hundreds of thousands of device operations of a window
takes longer than the window.  Only the device's operations (kernels,
copies, fills) are kept, as (name, start, seconds) on the host clock.

`busy_s` is the length of the union of their intervals inside the window, so
operations that overlap count once; the idle gaps are the window's
stretches outside that union, each put down to the innermost benchmark span
open on the host at its midpoint.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

TOP = 10


def annotation(e) -> bool:
    """Whether a device event is Kineto's device-side copy of a host
    annotation: a range, not work (`is_user_annotation` where this torch
    has it; the benchmark's own spans are also left out by name)."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def start(ctx, host: bool = True):
    """Start tracing the device (and, with `host`, the host's annotations);
    None on the CPU, where there is no device to trace."""
    if not ctx.on_card:
        return None
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerConfig, ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    from torch.profiler import ProfilerActivity

    acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA} if host else {ProfilerActivity.CUDA}
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    return _disable_profiler


def stop(disable, ctx) -> Optional[dict]:
    t0 = time.time()
    res = disable()
    w0, w1 = ctx.rec.window
    ops: List[Tuple[str, float, float]] = []
    spans = {name for name, _, _ in ctx.rec.spans}
    for e in res.events():
        if e.device_type().name != "CUDA" or e.name() in spans or annotation(e):
            continue
        s = e.start_ns() * 1e-9
        d = e.duration_ns() * 1e-9
        if s + d <= w0 or s >= w1:
            continue
        ops.append((e.name(), s, d))
    out = reduce(ops, ctx.rec.spans, (w0, w1))
    print(f"benchmark: trace of {len(ops)} device operations read in "
          f"{time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(spans, times: List[float]) -> List[str]:
    """For each host time of the ascending `times`, the name of the shortest
    span open then ("(no span)" where none is), by one sweep."""
    edges = sorted([(a, 0, i) for i, (_, a, _b) in enumerate(spans)]
                   + [(b, 1, i) for i, (_, _a, b) in enumerate(spans)])
    active: Dict[int, float] = {}
    out, k = [], 0
    for t in times:
        while k < len(edges) and (edges[k][0] < t or (edges[k][0] == t and edges[k][1] == 0)):
            _, kind, i = edges[k]
            if kind == 0:
                active[i] = spans[i][2] - spans[i][1]
            else:
                active.pop(i, None)
            k += 1
        out.append(spans[min(active, key=active.get)][0] if active else "(no span)")
    return out


def reduce(ops: List[Tuple[str, float, float]], spans, window: Tuple[float, float]) -> dict:
    w0, w1 = window
    busy = merge([(max(s, w0), min(s + d, w1)) for _, s, d in ops])
    busy_s = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = defaultdict(float)
    for name, _, d in ops:
        by_op[name[:160]] += d
    gaps = []
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    by_gap: Dict[str, float] = defaultdict(float)
    names = innermost(list(spans), [(a + b) / 2 for a, b in gaps])
    for (a, b), name in zip(gaps, names):
        by_gap[name] += b - a
    return {
        "ops": ops,
        "busy_s": busy_s,
        "window_s": w1 - w0,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in by_gap.items()), key=lambda kv: -kv[1])[:TOP],
    }
