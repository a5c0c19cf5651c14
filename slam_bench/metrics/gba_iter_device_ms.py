"""Device time (ms) of the operations launched inside one `bundle_adjust` call (one LM iteration), per iteration."""

from slam_bench.metrics._ranges import per_call


def read(r):
    v = per_call(r, "gba_iter", "device_s")
    return None if v is None else v * 1e3
