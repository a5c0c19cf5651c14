"""Median device-timeline length (ms) of `ba.linearize` over the window's
unprofiled `bundle_adjust` calls, from CUDA event pairs: residuals,
Jacobians, the U / V / b segment sums, V^-1 and the Schur right-hand
side."""

from slam_bench.metrics._spans import device_median_ms


def read(r):
    return device_median_ms(r, "ba.linearize")
