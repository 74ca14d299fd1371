"""Flow and metrics (`ops/flow.py`, `csrc/tvl1.cu`): the device time of K7's
launches (`benchmarks/roofline/tvl1.py`'s kernel) in the traced window per
scored frame, in ms."""

from benchmarks.roofline import tvl1


def read(rec):
    times = rec.kernel_times(lambda n: tvl1.NAME in n)
    frames = rec.counters.get("frames")
    return sum(times) / frames * 1e3 if times and frames else None
