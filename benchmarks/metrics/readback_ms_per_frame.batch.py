"""Engine and graphs (`stream/driver.py`): the read-back of a batch call's
stabilized frames and black counts into pageable host memory, where the
host waits for the scan's replays (the program's span `driver.readback`),
in ms per stabilized frame (`driver.batch`'s `frames`), summed over the
window's calls."""

from benchmarks import spans


def read(rec):
    return spans.ms_per(rec, "driver.readback", None, ("driver.batch", "frames"))
