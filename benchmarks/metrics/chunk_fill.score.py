"""Flow and metrics (`eval/metrics.py`): the frame pairs scored over the
slots of the metrics chunks they were padded to (the counters `pairs` and
`slots` of the program's span `score.pairs`, a chunk being 32 pairs), in %,
summed over the window's clips."""

from benchmarks import spans


def read(rec):
    kept = spans.program_spans(rec, "score.clip")
    slots = spans.total(kept, "score.pairs", "slots") if kept else 0
    return 100.0 * spans.total(kept, "score.pairs", "pairs") / slots if slots else None
