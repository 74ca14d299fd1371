"""Kernels (`ops/cuda_warp.py`, `csrc/warp_grad.cu`): K4's least time at the
training step's shape (`benchmarks/roofline/k4.py`) over the device time of
one call, its three passes together (the traced window's time of all three
over the launches of the last), in %."""

from benchmarks.roofline import k4, least_seconds


def read(rec):
    shape = rec.counters.get("k4_shape")
    calls = rec.kernel_times(lambda n: k4.NAMES[-1] in n)
    times = rec.kernel_times(lambda n: any(k in n for k in k4.NAMES))
    if not calls or not shape:
        return None
    least = least_seconds(k4.nbytes(*shape), k4.ops(*shape), rec.device["kind"])
    return None if least is None else 100.0 * least / (sum(times) / len(calls))
