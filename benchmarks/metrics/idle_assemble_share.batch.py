"""Driver layer (`stream/driver.py`): the share of the traced window's
device-idle time that falls in the self time of the program's span
`driver.assemble` (the rest of a batch call after its read-back), in %."""

from benchmarks import spans


def read(rec):
    return spans.idle_share(rec, "driver.assemble", "driver.batch")
