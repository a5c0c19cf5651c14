"""Median device-timeline length (ms) of `ba.solve` over the window's
unprofiled `bundle_adjust` calls, from CUDA event pairs: the camera
solve, the cell's 64 PCG steps."""

from slam_bench.metrics._spans import device_median_ms


def read(r):
    return device_median_ms(r, "ba.solve")
