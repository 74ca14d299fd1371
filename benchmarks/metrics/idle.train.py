"""Device: the share of the traced training window's wall time in which no
device operation (kernel, copy or fill) ran, from the union of their
intervals on one profiler timeline, in %."""


def read(rec):
    return rec.idle_pct()
