"""Driver layer (`stream/driver.py`): the host's grays of a batch call
(`video_io.to_gray_train` over every frame, the counter `gray_s` of the
program's span `driver.pre`), in ms per stabilized frame (`driver.batch`'s
`frames`), summed over the window's calls."""

from benchmarks import spans


def read(rec):
    return spans.ms_per(rec, "driver.pre", "gray_s", ("driver.batch", "frames"))
