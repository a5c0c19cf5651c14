"""Median device-timeline length (ms) of `ba.update` over the window's
unprofiled `bundle_adjust` calls, from CUDA event pairs: back-substitution,
the exp map, the new cost and keep-or-undo."""

from slam_bench.metrics._spans import device_median_ms


def read(r):
    return device_median_ms(r, "ba.update")
