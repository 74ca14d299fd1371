"""Kernels (`ops/cuda_warp.py`, `csrc/warp_grad.cu`): K6b's least time at
the training step's shape (`benchmarks/roofline/k6b.py`) over its mean
device time per launch in the traced window, in %."""

from benchmarks.roofline import k6b, least_seconds


def read(rec):
    times = rec.kernel_times(lambda n: k6b.NAME in n)
    shape = rec.counters.get("k6b_shape")
    if not times or not shape:
        return None
    least = least_seconds(k6b.nbytes(*shape), k6b.ops(*shape), rec.device["kind"])
    return None if least is None else 100.0 * least / (sum(times) / len(times))
