"""Flow and metrics (`eval/metrics.py`): the share of the traced window's
device-idle time that falls in the self time of the program's span
`score.pairs` (the padding, copy-in, chunk replays and copy-out of a call
for homographies), in %."""

from benchmarks import spans


def read(rec):
    return spans.idle_share(rec, "score.pairs", "score.clip")
