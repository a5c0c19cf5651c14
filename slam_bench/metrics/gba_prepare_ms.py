"""Median device-timeline length (ms) of `ba.prepare` over the window's
unprofiled `bundle_adjust` calls, from CUDA event pairs: the per-call
preparation, the segment layouts and the starting cost."""

from slam_bench.metrics._spans import device_median_ms


def read(r):
    return device_median_ms(r, "ba.prepare")
