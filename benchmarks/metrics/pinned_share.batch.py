"""Engine and graphs (`stream/engine.py`, `stream/driver.py`): the share of
a batch call's host bytes that crossed to or from the card through
page-locked buffers, in % (the counters `pinned_bytes` and `pageable_bytes`
of the program's spans `engine.upload` and `driver.readback`), summed over
the window's calls.  None where the program keeps no such counters."""

from benchmarks import spans

COPIES = ("engine.upload", "driver.readback")


def read(rec):
    kept = spans.program_spans(rec, "driver.batch") or []
    pinned = sum(spans.total(kept, name, "pinned_bytes") for name in COPIES)
    pageable = sum(spans.total(kept, name, "pageable_bytes") for name in COPIES)
    moved = pinned + pageable
    return 100.0 * pinned / moved if moved else None
