"""The device's idle share (%) of an unprofiled LM iteration: 1 minus the
traced solve's device busy time per iteration (`busy_s` / iterations)
over the median device-timeline length of the window's `ba.bundle_adjust`
calls (CUDA event pairs)."""

from slam_bench.metrics._spans import device_median_ms


def read(r):
    timeline = device_median_ms(r, "ba.bundle_adjust")
    if timeline is None:
        return None
    return 100.0 * (1.0 - r["trace"]["busy_s"] * 1e3 / r["iterations"] / timeline)
