"""Kernels (`ops/flow.py`, `csrc/tvl1.cu`): K7's least time per launch over
its mean device time per launch in the traced window, in %.  The least time
is that of the pixel updates of the window's scored clips
(`benchmarks/roofline/tvl1.py` on the counter `tvl1_px` of the program's
span `score.pairs`) over their launches (its counter `tvl1_launches`)."""

from benchmarks import spans
from benchmarks.roofline import least_seconds, tvl1


def read(rec):
    times = rec.kernel_times(lambda n: tvl1.NAME in n)
    kept = spans.program_spans(rec, "score.clip") if times else None
    px = spans.total(kept, "score.pairs", "tvl1_px") if kept else 0
    launches = spans.total(kept, "score.pairs", "tvl1_launches") if kept else 0
    if not px or not launches:
        return None
    least = least_seconds(tvl1.nbytes(px), tvl1.ops(px), rec.device["kind"])
    return None if least is None else 100.0 * (least / launches) / (sum(times) / len(times))
