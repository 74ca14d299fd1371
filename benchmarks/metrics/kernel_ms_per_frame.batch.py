"""Kernels (`ops/cuda_warp.py`, `csrc/`, the model's graphs): the union of
the traced window's kernels alone, the copies and fills left out, per
stabilized frame, in ms.  Beside `device_ms_per_frame.batch`, whose spread
the pageable copies carry, it is the steadier reading of the card's own
compute."""

from benchmarks.harness.trace import merge


def read(rec):
    c = rec.counters
    if not rec.on_card or not c.get("frames"):
        return None
    w0 = rec.window_start
    w1 = w0 + rec.reduced["window_s"]
    spans = merge([(max(s, w0), min(s + d, w1)) for n, s, d in rec.reduced["ops"]
                   if not n.startswith(("Memcpy", "Memset"))])
    return sum(b - a for a, b in spans if b > a) / c["frames"] * 1e3
