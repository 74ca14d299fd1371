"""Kernels (`ops/cuda_warp.py`, `csrc/warp.cu`): K1's least time at the
cell's shape (`benchmarks/roofline/k1.py`) over its mean device time per
launch in the traced window, in %."""

from benchmarks.roofline import k1, least_seconds


def read(rec):
    times = rec.kernel_times(lambda n: k1.NAME in n)
    shape = rec.counters.get("k1_shape")
    if not times or not shape:
        return None
    least = least_seconds(k1.nbytes(*shape), k1.ops(*shape), rec.device["kind"])
    return None if least is None else 100.0 * least / (sum(times) / len(times))
