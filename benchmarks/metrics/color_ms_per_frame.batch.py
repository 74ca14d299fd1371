"""Driver layer (`stream/driver.py`): the host's color copies of a batch
call (each frame resized to the output size and copied into the call's
color array, the counter `color_s` of the program's span `driver.pre`), in
ms per stabilized frame (`driver.batch`'s `frames`), summed over the
window's calls."""

from benchmarks import spans


def read(rec):
    return spans.ms_per(rec, "driver.pre", "color_s", ("driver.batch", "frames"))
