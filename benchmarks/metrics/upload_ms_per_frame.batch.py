"""Engine and graphs (`stream/engine.py`): the upload of a batch call's
grays and colors from pageable host memory (the program's span
`engine.upload`), in ms per stabilized frame (`driver.batch`'s `frames`),
summed over the window's calls."""

from benchmarks import spans


def read(rec):
    return spans.ms_per(rec, "engine.upload", None, ("driver.batch", "frames"))
