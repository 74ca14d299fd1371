"""Flow and metrics (`eval/metrics.py`): the share of the traced window's
device-idle time that falls in the self time of the program's span
`score.reduce` (the scores from the homographies and their reads to the
host), in %."""

from benchmarks import spans


def read(rec):
    return spans.idle_share(rec, "score.reduce", "score.clip")
