"""Driver layer (`stream/driver.py`): the rest of a batch call after its
read-back (frame 0's resize, `np.concatenate` of each clip's frames, the
crop rectangle and slices; the program's span `driver.assemble`), in ms per
stabilized frame (`driver.batch`'s `frames`), summed over the window's
calls."""

from benchmarks import spans


def read(rec):
    return spans.ms_per(rec, "driver.assemble", None, ("driver.batch", "frames"))
