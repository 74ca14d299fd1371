"""Kernels (`ops/cuda_warp.py`, `csrc/warp.cu`): K2m's least time at the
cell's shape (`benchmarks/roofline/k2m.py`) over its mean device time per
launch in the traced window, in %."""

from benchmarks.roofline import k2m, least_seconds


def read(rec):
    times = rec.kernel_times(lambda n: k2m.NAME in n)
    shape = rec.counters.get("k2m_shape")
    if not times or not shape:
        return None
    least = least_seconds(k2m.nbytes(*shape), k2m.ops(*shape), rec.device["kind"])
    return None if least is None else 100.0 * least / (sum(times) / len(times))
